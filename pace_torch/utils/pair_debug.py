"""Pair-debug: run a function under two placements and compare.

Port of `pace_tpu.utils.pair_debug` (the reference's pair_debug mode,
ai2cm/pace driver/pace/driver/driver.py:389-395 + dsl stencil.py:242-265,
which runs two model copies and compares every stencil argument).  A
placement is a function `place(fn, args) -> outputs`: `replicated` runs fn
on the whole cube in this process; `layout_placement(partition, comm)`
runs it on this rank's block of a rank layout (whole tiles, or boxes that
split tiles along x and y) and gathers the outputs, the counterpart of the
reference package's `mesh_placement`.  Outputs are
compared leaf by leaf, NaNs at the same places counting as equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from pace_torch.grid.generation import GridData
from pace_torch.parallel.topology import CubedSphereTopology
from pace_torch.utils.gridtools import Domain

# Values a placement replaces whole instead of leaf by leaf.
_UNITS = (GridData, Domain)


class PairDebugMismatch(AssertionError):
    pass


def _leaves_with_names(tree):
    """(names, leaves) of a dataclass (its fields), a dict (its keys), a
    tuple or list (indices) or a single leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return names, [getattr(tree, n) for n in names]
    if isinstance(tree, dict):
        return list(tree), list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [str(i) for i in range(len(tree))], list(tree)
    return ["0"], [tree]


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def compare_under_placements(
    fn: Callable,
    args,
    place_a: Callable,
    place_b: Callable,
    atol: float = 0.0,
    rtol: float = 0.0,
    window: Optional[Callable] = None,
) -> dict:
    """Run fn under place_a and place_b and compare the outputs.

    window: optional array -> array restricting the comparison of leaves
    of three or more dimensions (e.g. to the compute domain).  Returns a
    dict of per-leaf max abs differences; raises PairDebugMismatch if any
    leaf exceeds atol + rtol * max |reference| (place_a's output is the
    reference)."""
    out_a = place_a(fn, args)
    out_b = place_b(fn, args)
    names, leaves_a = _leaves_with_names(out_a)
    _, leaves_b = _leaves_with_names(out_b)
    report, failures = {}, []
    for name, a, b in zip(names, leaves_a, leaves_b):
        a, b = _as_numpy(a), _as_numpy(b)
        if window is not None and a.ndim >= 3:
            a, b = window(a), window(b)
        both_nan = np.isnan(a) & np.isnan(b)
        err = np.where(both_nan, 0.0, np.abs(a - b))
        err = np.nan_to_num(err, nan=np.inf)
        max_err = float(err.max()) if err.size else 0.0
        report[name] = max_err
        tol = atol + rtol * float(np.nan_to_num(np.abs(a), nan=0.0).max())
        if max_err > tol:
            failures.append(f"{name}: max err {max_err:.3e} > {tol:.3e}")
    if failures:
        raise PairDebugMismatch("; ".join(failures))
    return report


def replicated(fn: Callable, args):
    """Run fn on the whole cube, in this process."""
    return fn(*args)


def _map(tree, leaf_fn):
    """tree with every leaf replaced by leaf_fn(leaf); dataclasses (but a
    GridData or a Domain, which are leaves here), dicts, tuples and lists
    are rebuilt."""
    if isinstance(tree, _UNITS):
        return leaf_fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), leaf_fn)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, leaf_fn) for v in tree)
    return leaf_fn(tree)


def _tiled(leaf, tiles: int) -> bool:
    return (isinstance(leaf, (torch.Tensor, np.ndarray)) and leaf.ndim >= 2
            and leaf.shape[0] == tiles)


def layout_placement(partition, comm=None):
    """A placement running fn on the block of this rank of `partition`
    (parallel/partition.py, any layout): every array leaf of the arguments
    with a leading axis of 6 and three or more dimensions is cut to the
    rank's held box (under whole tiles, every such leaf of two or more
    dimensions to its tiles), a `GridData` to the rank's grid (the edge
    tables along their own axes), a `CubedSphereTopology` becomes the
    rank's `RankTopology` and a `Domain` the rank's; every output leaf with
    a leading axis of the rank's tile count is gathered from all ranks (the
    owned boxes), so each rank returns the whole cube's outputs.

    With `comm` None, the ranks run one after another in this process and
    no halo exchange can take place: a check that fn (without halo
    updates) does not depend on the points beyond its held box."""
    from pace_torch.parallel.halo import RankTopology

    k = partition.tiles_per_rank

    def run_rank(fn, args, rank):
        def cut(leaf):
            if isinstance(leaf, CubedSphereTopology):
                return RankTopology(partition, rank, comm)
            if isinstance(leaf, Domain):
                return partition.domain(rank)
            if isinstance(leaf, GridData):
                return leaf.scattered(partition.scatterer(rank))
            if not _tiled(leaf, 6):
                return leaf
            part = partition.scatter(leaf, rank)
            # a block of a split tile is a strided view: the kernels take
            # contiguous tensors
            return (part.contiguous() if isinstance(part, torch.Tensor)
                    else np.ascontiguousarray(part))

        return fn(*_map(tuple(args), cut))

    def gather(parts):
        names, first = _leaves_with_names(parts[0])
        leaves = [_leaves_with_names(p)[1] for p in parts]
        out = []
        for i, leaf in enumerate(first):
            if _tiled(leaf, k):
                out.append(partition.gather([_as_numpy(p[i])
                                             for p in leaves]))
            else:
                out.append(_as_numpy(leaf))
        return dict(zip(names, out))

    def place(fn, args):
        if comm is None:
            return gather([run_rank(fn, args, r)
                           for r in range(partition.size)])
        mine = _leaves_with_names(run_rank(fn, args, comm.rank))
        return gather(comm.all_gather(
            dict(zip(mine[0], [_as_numpy(v) for v in mine[1]]))))

    return place
