"""Savepoint ("translate") test harness for Fortran-serialized data.

The port's own copy of `pace_tpu.utils.translate`: reads the reference's
savepoint NetCDF format -- per-test ``<Savepoint>-In.nc`` /
``<Savepoint>-Out.nc`` files with ``(rank, savepoint, ...)`` dimensions --
assembles the per-rank Fortran blocks into global cube arrays, runs a
registered case on them, and compares the outputs against the reference
with the relative/near-zero error metric and per-test threshold overrides.
The files `write_savepoint` writes equal the reference package's byte for
byte.

Counterpart of ai2cm/pace's translate framework
(stencils/pace/stencils/testing/translate.py:53 TranslateFortranData2Py,
savepoint.py:32 SavepointCase, conftest.py:157-180 file discovery,
test_translate.py threshold handling), with two differences by design:

- storage is the global (6, N, N, nz) cube layout, so a case assembles all
  ranks of a tile-decomposed savepoint into one array and runs the
  whole-cube op once (per-rank slices come back out for the comparison);
- NetCDF3 via scipy (same on-disk format).

Everything here is host numpy; the cases of `utils.translate_cases*` move
the assembled inputs to their device once and bring the outputs back.

Threshold overrides follow the reference YAML schema
(fv3core/tests/savepoint/translate/overrides/baroclinic.yaml):

    TestName:
      - backend: all
        max_error: 1e-12
        near_zero: 1e-15
        ignore_near_zero_errors: [qcld, q_con]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pace_torch.utils import testing
from pace_torch.utils.netcdf import read_dataset_with_dims, write_dataset


def _select_axes(arr: np.ndarray, dims: Tuple[str, ...], rank: int,
                 i_call: int) -> np.ndarray:
    """Index away leading 'rank' and 'savepoint' axes when present."""
    out = arr
    # index in reverse order so positions stay valid
    positions = []
    for name, idx in (("rank", rank), ("savepoint", i_call)):
        if name in dims:
            positions.append((dims.index(name), idx))
    for pos, idx in sorted(positions, reverse=True):
        out = np.take(out, idx, axis=pos)
    return out


class SavepointDataset:
    """One savepoint's -In.nc/-Out.nc pair.

    ``inputs(rank, i_call)`` / ``outputs(rank, i_call)`` return dicts of
    numpy arrays (scalars unwrapped), the analogue of the reference's
    ``SavepointCase.ds_in/ds_out`` (savepoint.py:49-63)."""

    def __init__(self, data_dir: str, name: str):
        self.name = name
        self.data_dir = data_dir
        self._in = read_dataset_with_dims(
            os.path.join(data_dir, f"{name}-In.nc"))
        out_path = os.path.join(data_dir, f"{name}-Out.nc")
        self._out = (
            read_dataset_with_dims(out_path)
            if os.path.exists(out_path) else None
        )

    @property
    def n_ranks(self) -> int:
        arrays, dims = self._in
        for name, d in dims.items():
            if "rank" in d:
                return arrays[name].shape[d.index("rank")]
        return 1

    @property
    def n_calls(self) -> int:
        arrays, dims = self._in
        for name, d in dims.items():
            if "savepoint" in d:
                return arrays[name].shape[d.index("savepoint")]
        return 1

    def _get(self, pair, rank: int, i_call: int) -> Dict[str, np.ndarray]:
        arrays, dims = pair
        out = {}
        for name, arr in arrays.items():
            sel = _select_axes(arr, dims[name], rank, i_call)
            out[name] = sel.item() if sel.ndim == 0 else sel
        return out

    def inputs(self, rank: int, i_call: int = 0) -> Dict[str, np.ndarray]:
        return self._get(self._in, rank, i_call)

    def outputs(self, rank: int, i_call: int = 0) -> Dict[str, np.ndarray]:
        if self._out is None:
            raise FileNotFoundError(f"{self.name}-Out.nc not present")
        return self._get(self._out, rank, i_call)


def discover_savepoints(data_dir: str) -> List[str]:
    """Savepoint names present in a data directory (conftest.py:178)."""
    names = []
    for fname in sorted(os.listdir(data_dir)):
        if fname.endswith("-In.nc"):
            names.append(fname[: -len("-In.nc")])
    return names


def load_threshold_overrides(path: Optional[str]) -> Dict[str, dict]:
    """Parse the reference's threshold-overrides YAML (test_translate.py
    ``--threshold_overrides_file``): name -> {max_error, near_zero,
    ignore_near_zero_errors}, from the entries whose backend is "all",
    "torch" or "cuda"."""
    if path is None:
        return {}
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    out = {}
    for name, entries in raw.items():
        if isinstance(entries, dict):
            entries = [entries]
        for entry in entries:
            if entry.get("backend", "all") not in ("all", "torch", "cuda"):
                continue
            out[name] = {
                "max_error": float(entry.get("max_error", 1e-14)),
                "near_zero": float(entry.get("near_zero", 1e-18)),
                "ignore_near_zero_errors": entry.get(
                    "ignore_near_zero_errors", []),
            }
    return out


@dataclasses.dataclass
class VarSpec:
    """Layout of one savepoint variable.

    Fortran savepoint arrays are per-rank (i, j, k) blocks including
    halos; `istart/jstart` give the storage offset of the block's first
    point in our (tile, i, j, k) global cube (0 = first halo row for
    halo-inclusive fields, `halo` for compute-domain-only fields) —
    for multi-rank layouts these are the offsets of the SUBTILE-local
    block relative to the subtile's compute origin (the same numbers;
    see `assemble`).

    `kaxis=1` marks Fortran (i, k, j)-ordered storage (the reference's
    `pe`/`peln` convention, translate.py "kaxis"): the block is
    transposed to (i, j, k) on read and back on write.  `no_j=True`
    marks j-collapsed (i, k[, extra]) blocks (reference Fillz `axis: 1`
    with a squeezed j); they assemble to (6, Ni, ...) arrays with no j
    axis.  `column=True` marks per-rank 1-D column data (ak/bk/pfull):
    identical on every rank, passed through unassembled."""

    serialname: Optional[str] = None   # name in the savepoint file
    istart: int = 0
    jstart: int = 0
    kstart: int = 0
    kaxis: Optional[int] = None
    no_j: bool = False
    column: bool = False
    # optional=True: skip silently when the savepoint does not serialize
    # this variable (framework-internal storages, e.g. d_sw's ut/vt)
    optional: bool = False
    # GFS physics block layouts (reference translate_physics.py):
    # phys_order = "C"/"F" marks an IPD block serialized as
    # (cn*cn, nz[, ntracer]) with k stored surface-up — reshaped to
    # (cn, cn, nz[, t]) in the given index order and k-reversed on read
    # (transform_physics_serialized_data).  roll_zero applies the
    # reference's in/out_roll_zero k-shift.  microph marks the
    # microphysics block family ((cn*cn, 1, nz) 3D / (cn*cn, 1) 2D,
    # no k reversal — transform_microphysics_serialized_data).
    phys_order: Optional[str] = None
    roll_zero: bool = False
    microph: bool = False


def rank_to_tile_subtile(rank: int, layout: Tuple[int, int]):
    """rank -> (tile, sy, sx) for a (layout_y, layout_x) decomposition,
    matching the reference's rank ordering (CubedSpherePartitioner:
    tile = rank // ranks_per_tile; TilePartitioner.subtile_index:
    (rank // layout[1], rank % layout[1]) — x fastest)."""
    ly, lx = layout
    per_tile = ly * lx
    tile = rank // per_tile
    sub = rank % per_tile
    return tile, sub // lx, sub % lx


class TranslateCase:
    """Base translate case: assemble global arrays from all ranks, run
    `compute`, slice per-rank outputs back, compare against -Out.

    Subclasses set `in_vars` / `out_vars` ({name: VarSpec}) and implement
    `compute(inputs) -> outputs` on global (6, N, N[, nz]) arrays.
    Mirrors TranslateFortranData2Py.compute/slice_output
    (translate.py:75-260) for any (layout_y x layout_x)-per-tile
    decomposition (reference parallel_translate.py:14)."""

    max_error = 1e-14
    near_zero = 1e-18
    ignore_near_zero_errors: Sequence[str] = ()
    savepoint_name = ""
    # staggered write extents per variable for savepoint generation
    # (decompose): name -> (extra_i, extra_j)
    stagger: Dict[str, tuple] = {}

    def __init__(self, sizing, dtype=np.float64, layout=(1, 1)):
        self.sizing = sizing
        self.dtype = dtype
        self.layout = tuple(layout)
        if sizing.n % self.layout[0] or sizing.n % self.layout[1]:
            raise ValueError(
                f"layout {self.layout} does not divide n={sizing.n}")
        self.in_vars: Dict[str, VarSpec] = {}
        self.out_vars: Dict[str, VarSpec] = {}

    @property
    def n_ranks(self) -> int:
        return 6 * self.layout[0] * self.layout[1]

    # -- assembly ----------------------------------------------------------
    def _storage_shape(self):
        N = self.sizing.N
        return (6, N, N)

    def _block_origin(self, rank: int) -> Tuple[int, int, int]:
        """(tile, i0, j0): storage origin of this rank's subtile block
        (before the VarSpec istart/jstart offsets)."""
        tile, sy, sx = rank_to_tile_subtile(rank, self.layout)
        nsub_y = self.sizing.n // self.layout[0]
        nsub_x = self.sizing.n // self.layout[1]
        return tile, sx * nsub_x, sy * nsub_y

    @staticmethod
    def _from_fortran(block: np.ndarray, spec: VarSpec) -> np.ndarray:
        b = np.asarray(block)
        if spec.kaxis == 1 and b.ndim >= 3:
            b = np.swapaxes(b, 1, 2)  # (i, k, j) -> (i, j, k)
        return b

    @staticmethod
    def _to_fortran(block: np.ndarray, spec: VarSpec) -> np.ndarray:
        if spec.kaxis == 1 and block.ndim >= 3:
            return np.swapaxes(block, 1, 2)  # (i, j, k) -> (i, k, j)
        return block

    # -- GFS physics block layouts (reference translate_physics.py) -------
    @staticmethod
    def _phys_read(block: np.ndarray, spec: VarSpec) -> np.ndarray:
        """Serialized IPD/microphysics block -> (cn, cn[, k[, t]])
        top-down (the transform_*_serialized_data read path)."""
        b = np.asarray(block)
        cn = int(round(np.sqrt(b.shape[0])))
        if spec.microph:
            if b.ndim == 3:      # (cn*cn, 1, nz)
                return b[:, 0, :].reshape(cn, cn, b.shape[-1])
            if b.ndim == 2:      # (cn*cn, 1)
                return b.reshape(cn, cn)
            return b
        order = spec.phys_order
        if b.ndim == 2:          # (cn*cn, nz)
            arr = b.reshape(cn, cn, b.shape[1], order=order)[:, :, ::-1]
        elif b.ndim == 3:        # (cn*cn, nz, ntracer)
            arr = b.reshape(cn, cn, b.shape[1], b.shape[2],
                            order=order)[:, :, ::-1, :]
        else:
            raise NotImplementedError(f"phys block ndim {b.ndim}")
        if spec.roll_zero:
            arr = np.roll(arr, -1, axis=2)
        return arr

    @staticmethod
    def _phys_write(arr: np.ndarray, spec: VarSpec) -> np.ndarray:
        """(cn, cn[, k[, t]]) top-down -> serialized block (inverse of
        _phys_read)."""
        a = np.asarray(arr)
        cn = a.shape[0]
        if spec.microph:
            if a.ndim == 3:
                return a.reshape(cn * cn, a.shape[-1])[:, None, :]
            if a.ndim == 2:
                return a.reshape(cn * cn, 1)
            return a
        if spec.roll_zero:
            a = np.roll(a, 1, axis=2)
        order = spec.phys_order
        if a.ndim == 3:
            return a[:, :, ::-1].reshape(cn * cn, a.shape[2], order=order)
        if a.ndim == 4:
            return a[:, :, ::-1, :].reshape(
                cn * cn, a.shape[2], a.shape[3], order=order)
        raise NotImplementedError(f"phys array ndim {a.ndim}")

    def assemble(self, per_rank: List[Dict[str, np.ndarray]]):
        """Per-rank Fortran blocks -> global (6, N, N[, nz]) arrays.

        Each rank's block lands at its subtile origin plus the VarSpec
        offsets on its tile; blocks of adjacent subtiles overlap in their
        shared halo rows (consistent data from the serialized model, so
        last-write-wins is exact — the reference assembles the same way,
        parallel_translate.py state_from_inputs)."""
        if len(per_rank) != self.n_ranks:
            raise ValueError(
                f"layout {self.layout} expects {self.n_ranks} ranks; "
                f"got {len(per_rank)}"
            )
        out = {}
        for name, spec in self.in_vars.items():
            sname = spec.serialname or name
            if spec.optional and sname not in per_rank[0]:
                continue
            blocks = [r[sname] for r in per_rank]
            b0 = np.asarray(blocks[0])
            if b0.ndim == 0:
                out[name] = b0.item()
                continue
            if spec.column:
                out[name] = np.asarray(blocks[0], self.dtype)
                continue
            if spec.phys_order or spec.microph:
                h = self.sizing.halo
                b0r = self._phys_read(b0, spec)
                shape = self._storage_shape() + tuple(b0r.shape[2:])
                arr = np.zeros(shape, self.dtype)
                for rank, b in enumerate(blocks):
                    br = self._phys_read(np.asarray(b), spec)
                    tile, i0, j0 = self._block_origin(rank)
                    arr[tile,
                        h + i0:h + i0 + br.shape[0],
                        h + j0:h + j0 + br.shape[1]] = br
                out[name] = arr
                continue
            b0 = self._from_fortran(b0, spec)
            if spec.no_j:
                shape = (6, self.sizing.N) + tuple(b0.shape[1:])
            else:
                shape = self._storage_shape() + tuple(b0.shape[2:])
            arr = np.zeros(shape, self.dtype)
            for rank, b in enumerate(blocks):
                b = self._from_fortran(np.asarray(b), spec)
                tile, i0, j0 = self._block_origin(rank)
                if spec.no_j:
                    arr[tile, i0 + spec.istart:i0 + spec.istart
                        + b.shape[0]] = b
                else:
                    arr[
                        tile,
                        i0 + spec.istart:i0 + spec.istart + b.shape[0],
                        j0 + spec.jstart:j0 + spec.jstart + b.shape[1],
                    ] = b
            out[name] = arr
        return out

    def slice_output(self, name: str, global_arr: np.ndarray,
                     ref_block: np.ndarray, rank: int) -> np.ndarray:
        """Extract the (i, j[, k]) block matching the reference layout."""
        spec = self.out_vars[name]
        tile, i0, j0 = self._block_origin(rank)
        g = np.asarray(global_arr)
        if spec.column:
            return g
        if spec.phys_order or spec.microph:
            h = self.sizing.halo
            cn = int(round(np.sqrt(np.asarray(ref_block).shape[0])))
            block = g[tile, h + i0:h + i0 + cn, h + j0:h + j0 + cn]
            # trim k to the reference block's level count (kend variants)
            ref_r = self._phys_read(np.asarray(ref_block), spec)
            if block.ndim >= 3 and ref_r.ndim >= 3 \
                    and block.shape[2] != ref_r.shape[2]:
                block = block[:, :, :ref_r.shape[2]]
            return self._phys_write(block, spec)
        if spec.no_j:
            block = g[tile, i0 + spec.istart:i0 + spec.istart
                      + ref_block.shape[0]]
            return block
        ref_shape = self._from_fortran(ref_block, spec).shape
        block = g[
            tile,
            i0 + spec.istart:i0 + spec.istart + ref_shape[0],
            j0 + spec.jstart:j0 + spec.jstart + ref_shape[1],
        ]
        return self._to_fortran(block, spec)

    def compute(self, inputs: Dict) -> Dict:
        raise NotImplementedError

    # -- validation --------------------------------------------------------
    def validate(self, dataset: SavepointDataset, i_call: int = 0,
                 overrides: Optional[dict] = None) -> Dict[str, float]:
        """Run the case against one savepoint call; returns max metric
        error per output variable; raises AssertionError on failure."""
        cfg = overrides or {}
        max_error = cfg.get("max_error", self.max_error)
        near_zero = cfg.get("near_zero", self.near_zero)
        ignore_nz = set(cfg.get("ignore_near_zero_errors",
                                self.ignore_near_zero_errors))
        n_ranks = self.n_ranks
        if dataset.n_ranks != n_ranks:
            raise ValueError(
                f"dataset has {dataset.n_ranks} ranks; case layout "
                f"{self.layout} expects {n_ranks}"
            )
        per_rank = [dataset.inputs(r, i_call) for r in range(n_ranks)]
        inputs = self.assemble(per_rank)
        outputs = self.compute(inputs)
        expected = [dataset.outputs(r, i_call) for r in range(n_ranks)]
        errors = {}
        failures = []
        for name in self.out_vars:
            sname = self.out_vars[name].serialname or name
            worst = 0.0
            for rank in range(n_ranks):
                ref = np.asarray(expected[rank][sname])
                got = self.slice_output(name, outputs[name], ref, rank)
                ok = testing.success_array(
                    got.astype(np.float64), ref.astype(np.float64),
                    max_error, name in ignore_nz, near_zero,
                )
                err = testing.compare_arr(
                    got.astype(np.float64), ref.astype(np.float64))
                worst = max(worst, float(np.max(err)) if err.size else 0.0)
                if not ok.all():
                    bad = int((~ok).sum())
                    failures.append(
                        f"{name} rank {rank}: {bad}/{ok.size} points "
                        f"exceed max_error={max_error} "
                        f"(worst metric {float(np.max(err[~ok])):.3e})"
                    )
            errors[name] = worst
        if failures:
            raise AssertionError(
                f"{dataset.name}: " + "; ".join(failures))
        return errors

    def domain_errors(self, dataset: SavepointDataset, inputs=None,
                      i_call: int = 0) -> Tuple[Dict[str, float],
                                                Dict[str, float]]:
        """({output: max |computed - reference| / max |reference| over the
        compute domain of every rank's block (+1 on staggered axes)},
        {output: the worst per-point metric of `validate` over every
        block}), computing from `inputs` (by default the dataset's
        assembled inputs).  For savepoints written from a model run, whose
        halo cells hold values no operator defines and whose outputs can be
        near zero, where the per-point metric magnifies last-place
        differences.  Non-finite values must sit at the same places on the
        compute domain."""
        h, n = self.sizing.halo, self.sizing.n
        if inputs is None:
            inputs = self.assemble([dataset.inputs(r, i_call)
                                    for r in range(self.n_ranks)])
        outputs = self.compute(inputs)
        expected = [dataset.outputs(r, i_call) for r in range(self.n_ranks)]
        domain, metric = {}, {}
        for name, spec in self.out_vars.items():
            out = np.asarray(outputs[name], np.float64)
            sx, sy = (min(s, 1) for s in self.stagger.get(name, (0, 0)))
            mask = np.zeros(out.shape, bool)
            mask[:, h:h + n + sx, h:h + n + sy] = True
            err = scale = worst = 0.0
            for rank in range(self.n_ranks):
                ref = np.asarray(expected[rank][spec.serialname or name],
                                 np.float64)
                got = self.slice_output(name, out, ref, rank)
                with np.errstate(invalid="ignore", divide="ignore"):
                    point = np.where(got == ref, 0.0,
                                     testing.compare_arr(got, ref))
                worst = max(worst, float(np.nanmax(point, initial=0.0)))
                keep = self.slice_output(name, mask, ref, rank)
                g, r = got[keep], ref[keep]
                if not np.array_equal(np.isfinite(g), np.isfinite(r)):
                    raise AssertionError(f"{dataset.name}: {name} rank "
                                         f"{rank}: non-finite values differ")
                fin = np.isfinite(r)
                if fin.any():
                    err = max(err, float(np.abs(g[fin] - r[fin]).max()))
                    scale = max(scale, float(np.abs(r[fin]).max()))
            domain[name] = err / scale if scale else err
            metric[name] = worst
        return domain, metric

    # -- decomposition (inverse of assemble; for writing savepoints) -------
    def decompose(self, name: str, global_arr: np.ndarray, rank: int,
                  spec_map: Optional[Dict[str, VarSpec]] = None,
                  staggered: Tuple[int, int] = (0, 0)) -> np.ndarray:
        """Cut one rank's Fortran block out of a global array: the
        subtile compute domain plus its full halo collar (+ optional
        staggered extent), at the VarSpec offsets.  Used to produce
        reference-layout savepoints from this model's global state."""
        spec = (spec_map or self.in_vars)[name]
        tile, i0, j0 = self._block_origin(rank)
        h = self.sizing.halo
        nsub_y = self.sizing.n // self.layout[0]
        nsub_x = self.sizing.n // self.layout[1]
        g = np.asarray(global_arr)
        if spec.column:
            return g
        if spec.phys_order or spec.microph:
            block = g[tile,
                      h + i0:h + i0 + nsub_x,
                      h + j0:h + j0 + nsub_y]
            return self._phys_write(block, spec)
        # block extents: halo-inclusive blocks (istart=0) span
        # nsub + 2h (+stagger); compute-only blocks (istart=h) span
        # nsub (+stagger)
        ni = nsub_x + (2 * h if spec.istart == 0 else 0) + staggered[0]
        if spec.no_j:
            return g[tile, i0 + spec.istart:i0 + spec.istart + ni]
        nj = nsub_y + (2 * h if spec.jstart == 0 else 0) + staggered[1]
        block = g[
            tile,
            i0 + spec.istart:i0 + spec.istart + ni,
            j0 + spec.jstart:j0 + spec.jstart + nj,
        ]
        return self._to_fortran(block, spec)

    # -- savepoints of a run of this package ---------------------------------
    def input_blocks(self, inputs: Dict) -> List[Dict[str, np.ndarray]]:
        """Per-rank input blocks of global `inputs` in the reference
        layout, scalars as float64.  Non-finite values become 0 first:
        serialized reference data is finite, while halo cells of a live
        model state may hold non-finite scratch that no step reads (and the
        relative metric is NaN for a pair of equal infinities)."""
        inputs = {
            k: (np.nan_to_num(np.asarray(v), nan=0.0, posinf=0.0,
                              neginf=0.0) if np.ndim(v) else v)
            for k, v in inputs.items()
        }
        blocks = []
        for rank in range(self.n_ranks):
            block = {}
            for name, spec in self.in_vars.items():
                if name not in inputs:
                    if not spec.optional:
                        raise KeyError(f"{type(self).__name__}: no input "
                                       f"{name}")
                    continue
                value = inputs[name]
                block[spec.serialname or name] = (
                    np.float64(value) if np.ndim(value) == 0
                    else self.decompose(name, value, rank, staggered=(
                        self.stagger.get(name, (0, 0)))))
            blocks.append(block)
        return blocks

    def output_blocks(self, outputs: Dict) -> List[Dict[str, np.ndarray]]:
        """Per-rank output blocks of global `outputs` in the reference
        layout."""
        return [
            {spec.serialname or name: self.decompose(
                name, outputs[name], rank, spec_map=self.out_vars,
                staggered=self.stagger.get(name, (0, 0)))
             for name, spec in self.out_vars.items()}
            for rank in range(self.n_ranks)
        ]


def write_case_savepoint(case: TranslateCase, inputs: Dict,
                         data_dir: str) -> None:
    """Write `case`'s savepoint pair on global `inputs`: their blocks, and
    the blocks of what the case computes from the assembled form of those
    blocks (the arrays `validate` reassembles, so cells no block covers
    read as 0 in both)."""
    blocks = case.input_blocks(inputs)
    outputs = case.compute(case.assemble(blocks))
    write_savepoint(data_dir, case.savepoint_name, blocks,
                    case.output_blocks(outputs))


def write_savepoint(
    data_dir: str,
    name: str,
    inputs_per_rank: List[Dict[str, np.ndarray]],
    outputs_per_rank: Optional[List[Dict[str, np.ndarray]]] = None,
) -> None:
    """Write a savepoint pair in the reference's on-disk format
    ((rank, savepoint, ...) dims).  Used to produce interop data from
    this model (and to self-test the reader)."""
    os.makedirs(data_dir, exist_ok=True)

    def _write(suffix, per_rank):
        names = per_rank[0].keys()
        variables, dims = {}, {}
        for vname in names:
            stacked = np.stack(
                [np.asarray(r[vname]) for r in per_rank])[:, None]
            variables[vname] = stacked
            dims[vname] = ("rank", "savepoint") + tuple(
                f"dim_{vname}_{k}" for k in range(stacked.ndim - 2))
        write_dataset(
            os.path.join(data_dir, f"{name}-{suffix}.nc"), variables, dims)

    _write("In", inputs_per_rank)
    if outputs_per_rank is not None:
        _write("Out", outputs_per_rank)
