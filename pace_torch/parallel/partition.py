"""Rank layouts over the cubed sphere: who owns which storage points.

Counterpart of the layout logic of `pace_tpu.driver.driver.MeshConfig.build`
(a `(tile, x, y)` device mesh) and of the reference's
`CubedSpherePartitioner` (ai2cm/pace util/pace/util/partitioner.py).  A
layout `(t, x, y)` has `t * x * y` ranks: the six tiles split into `t`
groups of `6 / t` consecutive tiles, each tile's compute domain into `x`
parts along i and `y` parts along j.

Every point of the padded global storage `(6, N, N)` has exactly one owner:
a box of a rank runs from one compute-domain split to the next, and the
boxes at a tile's edges also own the halo and padding cells beyond it.  A
rank holds its box extended by `depth` lines (clipped to the storage): the
points outside its box are what a halo exchange fills.  Under `(t, 1, 1)`
a rank owns and holds whole tiles, `[r * 6 / t, (r + 1) * 6 / t)`.  Under x
or y above 1 a rank's `domain` (utils/gridtools.py `Domain`) tells the
operators which block of the tile storage it holds and where the tile's
edge lines fall in it; every box must be at least the halo's width, so
that a rank holding a tile corner holds every point a corner fill
reads.

Ranks are numbered host-major: with a `dcn_mesh_shape` (the hosts' grid)
each host holds a contiguous run of ranks, a block of shape
`layout / dcn_mesh_shape` of the mesh, as `torchrun` numbers one node's
processes together.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from pace_torch.utils import constants
from pace_torch.utils.gridtools import Domain, GridSizing


def check_layout(layout, dcn_mesh_shape=None) -> Tuple[int, int, int]:
    """The layout as a tuple of three positive ints; raises ValueError
    where the tile count does not divide 6 or `dcn_mesh_shape` does not
    divide the layout elementwise (as `MeshConfig.build` of the reference
    package)."""
    layout = tuple(int(v) for v in layout)
    if len(layout) != 3 or min(layout) < 1:
        raise ValueError(f"layout must be three positive ints, got {layout}")
    if 6 % layout[0]:
        raise ValueError(f"layout {layout}: the tile count {layout[0]} does "
                         "not divide 6")
    if dcn_mesh_shape is not None:
        dcn = tuple(int(v) for v in dcn_mesh_shape)
        if len(dcn) != 3 or min(dcn) < 1 or any(
                l % d for l, d in zip(layout, dcn)):
            raise ValueError(f"dcn_mesh_shape {dcn} does not divide layout "
                             f"{layout}")
    return layout


@dataclasses.dataclass(frozen=True)
class Box:
    """A block of the global storage: tiles [t0, t1), i [i0, i1), j
    [j0, j1)."""

    t0: int
    t1: int
    i0: int
    i1: int
    j0: int
    j1: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.t1 - self.t0, self.i1 - self.i0, self.j1 - self.j0)

    @property
    def index(self) -> Tuple[slice, slice, slice]:
        return (slice(self.t0, self.t1), slice(self.i0, self.i1),
                slice(self.j0, self.j1))


class Partition:
    """The ranks of a `(t, x, y)` layout on a C`n` grid with halo `h`."""

    def __init__(self, layout: Sequence[int], n: int,
                 h: int = constants.N_HALO_DEFAULT,
                 dcn_mesh_shape: Optional[Sequence[int]] = None):
        self.layout = check_layout(layout, dcn_mesh_shape)
        t, x, y = self.layout
        if n % x or n % y:
            raise ValueError(f"layout {self.layout} does not divide C{n}")
        if (x, y) != (1, 1) and min(n // x, n // y) < h:
            raise ValueError(
                f"layout {self.layout} at C{n}: its boxes of {n // x} x "
                f"{n // y} compute cells are narrower than the halo ({h})")
        self.n, self.h = n, h
        # the lines a rank holds past a side that borders another rank: the
        # halo and one more.  With h lines a step reads past the block:
        # d_sw's transport reads its flux preparation's area fluxes h lines
        # out, and those read the winds one line further; and a box of
        # exactly h cells beside a tile edge holds that edge's lines in its
        # halo, where the one-sided edge forms read one line further out.
        self.depth = h + 1
        self.N = GridSizing(n, 1, h).N
        self.dcn = (tuple(int(v) for v in dcn_mesh_shape)
                    if dcn_mesh_shape is not None else (1, 1, 1))
        self.ici = tuple(l // d for l, d in zip(self.layout, self.dcn))
        self.size = t * x * y

    @property
    def tiles_per_rank(self) -> int:
        return 6 // self.layout[0]

    @property
    def whole_tiles(self) -> bool:
        return self.layout[1] == self.layout[2] == 1

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """Mesh coordinates (tile group, x, y) of `rank`, host-major."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside [0, {self.size})")
        per_host = int(np.prod(self.ici))
        host, local = divmod(rank, per_host)
        hc = np.unravel_index(host, self.dcn)
        lc = np.unravel_index(local, self.ici)
        return tuple(int(a * i + b) for a, i, b in zip(hc, self.ici, lc))

    def tiles(self, rank: int) -> range:
        """The global tiles `rank` owns, in whole or in part."""
        k = self.tiles_per_rank
        g = self.coords(rank)[0]
        return range(g * k, (g + 1) * k)

    def _split(self, part: int, parts: int) -> Tuple[int, int]:
        """Storage range of compute-domain part `part` of `parts`, the
        first and last reaching the storage's ends."""
        step = self.n // parts
        lo = 0 if part == 0 else self.h + part * step
        hi = self.N if part == parts - 1 else self.h + (part + 1) * step
        return lo, hi

    def box(self, rank: int) -> Box:
        """The storage points `rank` owns."""
        _, cx, cy = self.coords(rank)
        tiles = self.tiles(rank)
        i0, i1 = self._split(cx, self.layout[1])
        j0, j1 = self._split(cy, self.layout[2])
        return Box(tiles.start, tiles.stop, i0, i1, j0, j1)

    def local_box(self, rank: int) -> Box:
        """The storage points `rank` holds: its box and `depth` lines
        around it, within the storage."""
        b, d, N = self.box(rank), self.depth, self.N
        return Box(b.t0, b.t1, max(b.i0 - d, 0), min(b.i1 + d, N),
                   max(b.j0 - d, 0), min(b.j1 + d, N))

    def domain(self, rank: int) -> Domain:
        """The block of each tile `rank` holds, as the operators see it."""
        b, lb = self.box(rank), self.local_box(rank)
        return Domain(self.n, self.h, self.N, lb.i0, lb.j0, lb.i1 - lb.i0,
                      lb.j1 - lb.j0, (b.i0, b.i1, b.j0, b.j1))

    def owners(self) -> np.ndarray:
        """(6, N, N) int array: the rank owning each storage point."""
        out = np.full((6, self.N, self.N), -1, dtype=np.int64)
        for rank in range(self.size):
            out[self.box(rank).index] = rank
        return out

    # -- moving arrays ------------------------------------------------------
    def scatter(self, array, rank: int, axis: Optional[int] = None):
        """`rank`'s part of a global array (numpy or tensor) whose leading
        axis is the tile: the held box of an array of three or more
        dimensions; of a (6, N) table running along `axis` (1: i, 2: j, as
        the grid's edge tables do) the rank's tiles and its held range
        along that axis; the tiles of a (6,) leaf.  Under whole tiles a
        (6, N) table needs no axis."""
        b = self.local_box(rank)
        if array.ndim >= 3:
            return array[b.index]
        if array.ndim == 2 and not self.whole_tiles:
            if axis not in (1, 2):
                raise ValueError("a (6, N) table is cut along the axis it "
                                 f"runs along (1 or 2), got {axis}")
            lo, hi = (b.i0, b.i1) if axis == 1 else (b.j0, b.j1)
            return array[b.t0:b.t1, lo:hi]
        return array[b.t0:b.t1]

    def scatterer(self, rank: int) -> Callable:
        """`scatter` bound to `rank`: the `scatter` argument of the state,
        grid and initial-state builders, which cut what they build on the
        host to the rank's part."""
        return functools.partial(self.scatter, rank=rank)

    def gather(self, parts: Sequence):
        """The global array from every rank's held part (in rank order):
        under whole tiles the parts (of any trailing shape, such as a
        compute-domain cut) joined along the tile axis, rank order being
        tile order; else each rank's owned box written into a (6, N, N,
        ...) array."""
        first = parts[0]
        if self.whole_tiles:
            if isinstance(first, torch.Tensor):
                return torch.cat(list(parts), 0)
            return np.concatenate([np.asarray(p) for p in parts], 0)
        shape = (6, self.N, self.N) + tuple(first.shape[3:])
        if isinstance(first, torch.Tensor):
            out = first.new_empty(shape)
        else:
            out = np.empty(shape, dtype=np.asarray(first).dtype)
        for rank, part in enumerate(parts):
            b, lb = self.box(rank), self.local_box(rank)
            out[b.index] = part[:, b.i0 - lb.i0:b.i1 - lb.i0,
                                b.j0 - lb.j0:b.j1 - lb.j0]
        return out
