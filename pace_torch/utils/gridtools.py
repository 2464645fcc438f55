"""Grid sizing and index bookkeeping for the global-view cubed-sphere layout.

Unlike the reference's per-rank `GridSizer`/`GridIndexing`
(ai2cm/pace util/pace/util/initialization/sizer.py, dsl/pace/dsl/stencil.py:542),
this framework keeps each full cube face on-array: every field is a global
array of shape ``(6, N, N, ...)`` where ``N = n + 2*halo + 1``.  Cell centers
``i in [0, n)`` live at array index ``i + halo``; interface index ``i`` lives
at ``i + halo``.  All six tiles share identical index geometry, so tile-edge
specializations are static slices, not masks.

A rank of a layout that splits tiles along x or y holds a block of that
storage (parallel/partition.py); `Domain` says which block, and the
operators keep indexing in the tile's storage coordinates through it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from pace_torch.utils import constants


@dataclasses.dataclass(frozen=True)
class GridSizing:
    """Static description of the per-tile index space.

    Attributes:
        n: number of cells along each horizontal tile axis (e.g. 48 for C48).
        nz: number of vertical levels (cell centers).
        halo: halo width in cells.
    """

    n: int
    nz: int
    halo: int = constants.N_HALO_DEFAULT

    @property
    def npx(self) -> int:
        """Number of interface points along x on the tile (n+1)."""
        return self.n + 1

    @property
    def npy(self) -> int:
        return self.n + 1

    @property
    def npz(self) -> int:
        return self.nz

    # --- storage shape ---------------------------------------------------
    @property
    def N(self) -> int:
        """Padded horizontal array size: n + 2*halo + 1 (room for interfaces)
        rounded up to a multiple of 8, the reference package's layout."""
        return -(-(self.n + 2 * self.halo + 1) // 8) * 8

    @property
    def shape2d(self) -> Tuple[int, int, int]:
        return (constants.N_TILES, self.N, self.N)

    @property
    def shape3d(self) -> Tuple[int, int, int, int]:
        return (constants.N_TILES, self.N, self.N, self.nz)

    @property
    def shape3d_kiface(self) -> Tuple[int, int, int, int]:
        return (constants.N_TILES, self.N, self.N, self.nz + 1)

    # --- compute-domain bounds -------------------------------------------
    @property
    def isc(self) -> int:
        """First compute cell index in storage coordinates."""
        return self.halo

    @property
    def iec(self) -> int:
        """One-past-last compute cell index (python slice convention)."""
        return self.halo + self.n

    # alias names for readability in stencil code
    @property
    def jsc(self) -> int:
        return self.halo

    @property
    def jec(self) -> int:
        return self.halo + self.n

    @property
    def ise(self) -> int:
        """One-past-last interface index (== halo + n + 1)."""
        return self.halo + self.n + 1

    def slice_compute(self, iface_x: bool = False, iface_y: bool = False):
        """(i, j) slices covering the compute domain."""
        sx = slice(self.halo, self.halo + self.n + (1 if iface_x else 0))
        sy = slice(self.halo, self.halo + self.n + (1 if iface_y else 0))
        return sx, sy

    def domain_shape(self, iface_x: bool = False, iface_y: bool = False):
        return (
            constants.N_TILES,
            self.n + (1 if iface_x else 0),
            self.n + (1 if iface_y else 0),
        )


def _local(g, offset: int, size: int):
    """A global storage index (int) or slice `g` along one axis, in the
    coordinates of a block starting at `offset` of extent `size`: None
    where the block holds none of it (an int outside, an empty slice)."""
    if isinstance(g, slice):
        if g.step not in (None, 1):
            raise ValueError(f"unsupported slice step {g.step}")
        lo = 0 if g.start is None else min(max(g.start - offset, 0), size)
        hi = size if g.stop is None else min(max(g.stop - offset, 0), size)
        return slice(lo, hi) if lo < hi else None
    m = int(g) - offset
    return m if 0 <= m < size else None


@dataclasses.dataclass(frozen=True)
class Domain:
    """The part of each tile's storage an operator works on: in one process
    the whole (N, N) storage; on a rank of a `(t, x, y)` layout the block
    the rank holds, its box and the lines around it (parallel/partition.py
    `Partition.depth`).

    The operators take a Domain in place of the tile's (n, halo) pair and
    keep writing their forms at the tile's storage indices (the tile's edge
    lines are h and h + n): `col`/`row` map such an index or slice into
    the block, and a form whose line the block does not hold is not
    written.  An operator on a block is thus the one-process operator
    restricted to it: each cell the block holds gets the form it gets in
    one process, so a tile-edge form lands only on a rank whose block
    holds that edge's lines.  The owned cells agree with one process
    wherever the operator's reach from them stays within the block.

    Attributes:
        n, h: cells along a tile edge and the halo width.
        N: the tile's storage extent, round_up(n + 2 h + 1, 8).
        i0, j0: the storage index of the block's first point along i, j.
        Ni, Nj: the block's extents.
        box: (i0, i1, j0, j1), the storage points the rank owns.
    """

    n: int
    h: int
    N: int
    i0: int
    j0: int
    Ni: int
    Nj: int
    box: Tuple[int, int, int, int]

    @classmethod
    def whole(cls, n: int, h: int = constants.N_HALO_DEFAULT) -> "Domain":
        """The whole tile: one process, or a rank of whole tiles."""
        N = GridSizing(n, 1, h).N
        return cls(n, h, N, 0, 0, N, N, (0, N, 0, N))

    @property
    def is_whole(self) -> bool:
        return (self.i0, self.j0, self.Ni, self.Nj) == (0, 0, self.N, self.N)

    def col(self, g):
        """Storage index or slice g along i, in the block (None: outside)."""
        return _local(g, self.i0, self.Ni)

    def row(self, g):
        """Storage index or slice g along j, in the block (None: outside)."""
        return _local(g, self.j0, self.Nj)

    def line(self, axis: int, g):
        """`col` for axis 1 (i), `row` for axis 2 (j)."""
        return self.col(g) if axis == 1 else self.row(g)

    def edge_lines(self, axis: int) -> Tuple[int, int]:
        """(low, high) local indices of the tile's two edge lines along
        `axis` (1: i, 2: j), whether or not the block holds them."""
        o = self.i0 if axis == 1 else self.j0
        return self.h - o, self.h + self.n - o

    def compute(self, iface_x: bool = False, iface_y: bool = False):
        """(i, j) local slices of the compute-domain points the rank owns:
        cells [h, h + n), or interfaces [h, h + n + 1) along an iface
        axis, within its box."""
        bi0, bi1, bj0, bj1 = self.box
        h, n = self.h, self.n
        si = slice(max(bi0, h) - self.i0,
                   min(bi1, h + n + int(iface_x)) - self.i0)
        sj = slice(max(bj0, h) - self.j0,
                   min(bj1, h + n + int(iface_y)) - self.j0)
        return si, sj
