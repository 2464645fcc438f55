"""Halo updates on cubed-sphere tensors, on one rank or over several.

Port of `pace_tpu.parallel.halo` (reference ai2cm/pace
util/pace/util/halo_updater.py:29).  With a `CubedSphereTopology` every
field is global, (6, N, N, ...), and a halo update is one advanced-indexing
gather with the topology's precomputed tables, moved to the tensor's device
once.  Vector updates fuse the tile-edge rotation (component swap + sign
flip) into the gather.

With a `RankTopology` each rank holds its part of the cube (a block of
6 / t tiles under a `(t, x, y)` layout, parallel/partition.py) and every
halo call is an `ExchangePlan`: the rank packs the values other ranks need into one
buffer, one exchange (parallel/comm.py) swaps the buffers, and one gather
over [own fields ‖ received rows] fills the halos.  The same functions
take either topology.

All functions accept tensors with any number of trailing dimensions after
(tile, i, j).  `HaloTrafficRecorder` (parallel/traffic.py) hooks the
one-rank path through `_RECORDER`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pace_torch.parallel.partition import Partition
from pace_torch.parallel.topology import (
    CubedSphereTopology,
    HaloSpec,
    get_topology,
)

# The active halo-traffic recorder (parallel/traffic.py), None unless a
# recorder's context is entered.
_RECORDER = None


def _expand(idx, ndim_extra):
    """Reshape a (6, N, N) table so it broadcasts over trailing dims."""
    return idx.reshape(idx.shape + (1,) * ndim_extra)


def gather_one_rank(t: dict, inputs: Sequence[torch.Tensor], lead: int = 0,
                    apply_sign: bool = True) -> torch.Tensor:
    """The one-rank gather with tables `t` (`HaloSpec.on`) from a scalar
    field ([q]) or a vector pair ([u, v]) whose tile axis follows `lead`
    leading axes."""
    at = (slice(None),) * lead + (t["t"], t["i"], t["j"])
    out = inputs[0][at]
    if len(inputs) == 2:
        extra = inputs[0].ndim - 3 - lead
        out = torch.where(_expand(t["comp"], extra) == 0, out, inputs[1][at])
        if apply_sign:
            out = _expand(t["sign"], extra).to(out.dtype) * out
    return out


def _one_rank(spec: HaloSpec, inputs, lead: int = 0,
              apply_sign: bool = True) -> torch.Tensor:
    """One output of a halo call on one rank: the gather, or under an
    active recorder the gather recorded or replayed."""
    if _RECORDER is not None and _RECORDER.mode == "replay":
        return _RECORDER.substitute(spec, inputs, lead, apply_sign)
    out = gather_one_rank(spec.on(inputs[0].device), inputs, lead,
                          apply_sign)
    if _RECORDER is not None:
        _RECORDER.on_result(out, spec.kind, lead)
    return out


def halo_update_scalar(q: torch.Tensor, spec) -> torch.Tensor:
    """Fill edge halos of a scalar field. Corner wedges keep prior values."""
    if isinstance(spec, ExchangePlan):
        return spec.run([q])[0]
    return _one_rank(spec, [q])


def halo_update_scalars(topo, fields: Sequence[torch.Tensor],
                        stagger: str = "center") -> list:
    """Grouped scalar halo update: one gather per field on one rank; over
    ranks the group rides one exchange, concatenated along the trailing
    axis (the structured path of the reference package does the same)."""
    spec = topo.scalar_spec(stagger)
    if isinstance(spec, ExchangePlan) and len(fields) > 1:
        return spec.run_grouped(list(fields))
    return [halo_update_scalar(f, spec) for f in fields]


def halo_update_corners(topo, stack: torch.Tensor):
    """(q_y, q_x) of a stack (T, tiles, N, N, ...): the halo update
    composed with the transport's corner copies (copy_corners "y", then
    "x"), as two gathers on one rank and one exchange over ranks."""
    specs = topo.scalar_corner_specs()
    if isinstance(specs, ExchangePlan):
        return tuple(specs.run([stack], lead=1))
    return tuple(_one_rank(spec, [stack], lead=1).contiguous()
                 for spec in specs)


def halo_update_vector(topo, u, v, u_stagger: str,
                       v_stagger: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill edge halos of a vector pair, rotating components across tile
    edges.  For D-grid winds use (u_stagger="y_iface", v_stagger="x_iface");
    C-grid ("x_iface", "y_iface"); A-grid ("center", "center")."""
    spec = topo.vector_spec(u_stagger, v_stagger)
    if isinstance(spec, ExchangePlan):
        return tuple(spec.run([u, v]))
    return tuple(_one_rank(s, [u, v]) for s in spec)


def halo_update_staggered_pair(topo, a_u, a_v, u_stagger: str,
                               v_stagger: str):
    """Halo update of two scalar fields on complementary staggered points
    (e.g. dx on y-interfaces, dy on x-interfaces): across rotating tile
    edges they swap roles as vector components do, with no sign flip (the
    data is unoriented)."""
    if isinstance(topo, RankTopology):
        return tuple(topo.vector_spec(u_stagger, v_stagger, signed=False)
                     .run([a_u, a_v]))
    return tuple(_one_rank(s, [a_u, a_v], apply_sign=False)
                 for s in topo.vector_spec(u_stagger, v_stagger))


def synchronize_vector_interfaces(topo, u, v, u_stagger: str,
                                  v_stagger: str):
    """Make edge-shared interface points of a vector pair agree across tiles
    (reference communicator.py:472-519): points on a tile's west/south
    compute-domain boundary take the neighbouring tile's value."""
    spec = topo.interface_sync_map(u_stagger, v_stagger)
    if isinstance(spec, ExchangePlan):
        return tuple(spec.run([u, v]))
    return tuple(_one_rank(s, [u, v]) for s in spec)


# ---------------------------------------------------------------------------
# Over ranks
# ---------------------------------------------------------------------------

def _flat(x: torch.Tensor, lead: int) -> torch.Tensor:
    """x with its (tile, i, j) axes, after `lead` leading axes, merged."""
    return x.reshape(x.shape[:lead] + (-1,) + x.shape[lead + 3:])


class ExchangePlan:
    """One halo call on one rank.

    The rank's `inputs` fields (1 for a scalar, 2 for a vector pair) are
    laid end to end, flattened over their held box (`local_shape`), and the
    received rows follow them: `ext = [input 0 ‖ input 1 ‖ received]`.
    `send` indexes the rows of `ext`'s input part bound for each rank, in
    rank order (`send_counts`); each output is `ext[gather]` (times `sign`
    for a vector component), reshaped to the held box.  A vector output
    reads u or v by where its index points, so the component selector of
    the one-rank tables is folded into `gather`."""

    def __init__(self, kind: str, comm, local_shape, inputs: int,
                 send: np.ndarray, send_counts, recv_counts,
                 gathers: List[np.ndarray],
                 signs: List[Optional[np.ndarray]]):
        self.kind = kind
        self.comm = comm
        self.local_shape = tuple(local_shape)
        self.inputs = inputs
        self.size = int(np.prod(local_shape))
        self.send = send
        self.send_counts = [int(c) for c in send_counts]
        self.recv_counts = [int(c) for c in recv_counts]
        self.gathers = gathers
        self.signs = signs
        self._device_copies = {}

    @property
    def recv_rows(self) -> int:
        return int(sum(self.recv_counts))

    def on(self, device) -> dict:
        device = torch.device(device)
        if device not in self._device_copies:
            def idx(a):
                return torch.as_tensor(a.reshape(-1), dtype=torch.int64,
                                       device=device)

            self._device_copies[device] = dict(
                send=idx(self.send),
                gathers=[idx(g) for g in self.gathers],
                signs=[None if s is None else torch.as_tensor(s,
                                                              device=device)
                       for s in self.signs])
        return self._device_copies[device]

    def _ext(self, inputs, lead: int):
        x0 = inputs[0]
        rows = self.inputs * self.size + self.recv_rows
        ext = x0.new_empty(x0.shape[:lead] + (rows,) + x0.shape[lead + 3:])
        for a, x in enumerate(inputs):
            ext.narrow(lead, a * self.size, self.size).copy_(_flat(x, lead))
        return ext

    def pack(self, ext: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The send buffer, rows first: `ext`'s rows bound for each rank."""
        rows = ext.index_select(lead, self.on(ext.device)["send"])
        return rows.movedim(lead, 0).contiguous() if lead else rows

    def unpack(self, ext: torch.Tensor, recv: torch.Tensor,
               lead: int = 0) -> list:
        """The outputs, with the received rows (rows first) in `ext`."""
        ext.narrow(lead, self.inputs * self.size, self.recv_rows).copy_(
            recv.movedim(0, lead) if lead else recv)
        t = self.on(ext.device)
        shape = ext.shape[:lead] + self.local_shape + ext.shape[lead + 1:]
        outs = []
        for gather, sign in zip(t["gathers"], t["signs"]):
            out = ext.index_select(lead, gather).reshape(shape)
            if sign is not None:
                out = _expand(sign, out.ndim - 3).to(out.dtype) * out
            outs.append(out)
        return outs

    def _exchange(self, send: torch.Tensor) -> torch.Tensor:
        if self.comm is None:
            raise RuntimeError(f"halo call {self.kind}: this rank topology "
                               "has no communicator to exchange through")
        return self.comm.exchange(send, self.send_counts, self.recv_counts)

    def run(self, inputs: Sequence[torch.Tensor], lead: int = 0) -> list:
        """Pack, exchange, gather: the outputs of the halo call."""
        ext = self._ext(inputs, lead)
        return self.unpack(ext, self._exchange(self.pack(ext, lead)), lead)

    def run_grouped(self, fields: List[torch.Tensor]) -> list:
        """A scalar plan over several fields of one dtype in one exchange:
        their trailing axes (flattened to one) laid side by side in the
        rows of `ext`, each output gathered from its own columns."""
        if any(f.dtype != fields[0].dtype for f in fields):
            return [self.run([f])[0] for f in fields]
        widths = [f[0, 0, 0].numel() for f in fields]
        ext = fields[0].new_empty((self.size + self.recv_rows, sum(widths)))
        offsets = np.cumsum([0] + widths)
        for f, start, width in zip(fields, offsets, widths):
            ext[:self.size, start:start + width].copy_(
                f.reshape(self.size, width))
        ext[self.size:].copy_(self._exchange(self.pack(ext)))
        gather = self.on(ext.device)["gathers"][0]
        return [ext.narrow(1, int(start), width).index_select(0, gather)
                .reshape(f.shape)
                for f, start, width in zip(fields, offsets, widths)]


def _source_keys(tables, box, N: int) -> np.ndarray:
    """Global keys ((field * 6 + tile) * N + i) * N + j of an output's
    sources at the points of `box`."""
    field, tile, i, j = (np.asarray(a)[box.index].astype(np.int64)
                         for a in tables)
    return ((field * 6 + tile) * N + i) * N + j


def build_plan(partition: Partition, rank: int, comm, kind: str,
               inputs: int, outputs) -> ExchangePlan:
    """The ExchangePlan of `rank` for one halo call.  `outputs` holds, for
    each output, the global source tables (field, tile, i, j), each
    (6, N, N), and a (6, N, N) sign table or None."""
    N, size = partition.N, partition.size
    owners = partition.owners().reshape(-1)
    plane = 6 * N * N

    def remote(r):
        """Sorted by (owner, key): the keys rank r reads from others."""
        box = partition.local_box(r)
        keys = np.unique(np.concatenate([
            _source_keys(tables, box, N).reshape(-1)
            for tables, _ in outputs]))
        own = owners[keys % plane]
        keys, own = keys[own != r], own[own != r]
        order = np.lexsort((keys, own))
        return keys[order], own[order]

    def local_index(keys, r):
        """Flat index of keys into rank r's [input 0 ‖ input 1 ...]."""
        box = partition.local_box(r)
        ti, li, lj = box.shape
        field, rest = np.divmod(keys, plane)
        t, rest = np.divmod(rest, N * N)
        i, j = np.divmod(rest, N)
        return field * (ti * li * lj) + (
            ((t - box.t0) * li + (i - box.i0)) * lj + (j - box.j0))

    box = partition.local_box(rank)
    local_size = int(np.prod(box.shape))
    recv_keys, recv_own = remote(rank)
    recv_counts = np.bincount(recv_own, minlength=size)
    by_key = np.argsort(recv_keys)
    gathers, signs = [], []
    for tables, sign in outputs:
        keys = _source_keys(tables, box, N)
        mine = owners[keys % plane] == rank
        pos = by_key[np.searchsorted(recv_keys[by_key], keys[~mine])]
        index = np.empty(keys.shape, dtype=np.int64)
        index[mine] = local_index(keys[mine], rank)
        index[~mine] = inputs * local_size + pos
        gathers.append(index)
        signs.append(None if sign is None
                     else np.asarray(sign, np.float32)[box.index])
    send, send_counts = [], []
    for dest in range(size):
        keys, own = remote(dest) if dest != rank else (np.empty(0, np.int64),
                                                       np.empty(0, np.int64))
        keys = keys[own == rank]
        send.append(local_index(keys, rank))
        send_counts.append(len(keys))
    return ExchangePlan(kind, comm, box.shape, inputs,
                        np.concatenate(send).astype(np.int64), send_counts,
                        recv_counts, gathers, signs)


class RankTopology:
    """The halo calls of one rank of a `Partition`, with the method surface
    the step calls on `CubedSphereTopology`: each returns an ExchangePlan
    built once from the global topology's tables.  `comm` (parallel/comm.py)
    carries the exchanges and the cross-rank reductions."""

    def __init__(self, partition: Partition, rank: int, comm=None):
        self.partition = partition
        self.rank = rank
        self.comm = comm
        self.n, self.halo, self.N = partition.n, partition.h, partition.N
        self.global_topology: CubedSphereTopology = get_topology(
            partition.n, partition.h)
        # the block of each tile the rank holds (utils/gridtools.py)
        self.domain = partition.domain(rank)

    def _plan(self, kind, inputs, outputs) -> ExchangePlan:
        return build_plan(self.partition, self.rank, self.comm, kind,
                          inputs, outputs)

    @staticmethod
    def _scalar_tables(spec: HaloSpec):
        return ((np.zeros_like(spec.src_tile), spec.src_tile, spec.src_i,
                 spec.src_j), None)

    @staticmethod
    def _vector_tables(spec: HaloSpec, signed: bool):
        return ((spec.src_comp, spec.src_tile, spec.src_i, spec.src_j),
                spec.sign if signed else None)

    @functools.lru_cache(maxsize=None)
    def scalar_spec(self, stagger: str = "center") -> ExchangePlan:
        spec = self.global_topology.scalar_spec(stagger)
        return self._plan(spec.kind, 1, [self._scalar_tables(spec)])

    @functools.lru_cache(maxsize=None)
    def scalar_corner_specs(self) -> ExchangePlan:
        specs = self.global_topology.scalar_corner_specs()
        return self._plan("scalar:center+corners", 1,
                          [self._scalar_tables(s) for s in specs])

    @functools.lru_cache(maxsize=None)
    def vector_spec(self, u_stagger: str, v_stagger: str,
                    signed: bool = True) -> ExchangePlan:
        specs = self.global_topology.vector_spec(u_stagger, v_stagger)
        return self._plan(f"vector:{u_stagger}:{v_stagger}", 2,
                          [self._vector_tables(s, signed) for s in specs])

    @functools.lru_cache(maxsize=None)
    def interface_sync_map(self, u_stagger: str,
                           v_stagger: str) -> ExchangePlan:
        specs = self.global_topology.interface_sync_map(u_stagger, v_stagger)
        return self._plan(f"ifsync:{u_stagger}:{v_stagger}", 2,
                          [self._vector_tables(s, True) for s in specs])

    def reduce_max(self, value: torch.Tensor) -> torch.Tensor:
        """The maximum of `value` over the ranks."""
        return self.comm.all_reduce(value, "max")
