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

`Partition.part(rank)` (`RankPart`) is what the grid builder, the
initial-state builders and the restart readers read to build a rank's
block alone: the held block, which of its points are compute points of
their tile, and the source of each held point in the topology's halo
gather.  The whole cube is the one part of layout (1, 1, 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from pace_torch.parallel.topology import get_topology
from pace_torch.utils import constants
from pace_torch.utils.gridtools import Domain, GridSizing

# the compute points of a staggering: storage lines [h, h + n + extra)
# along i and along j
_COMPUTE_EXTRA = {"center": (0, 0), "x_iface": (1, 0), "y_iface": (0, 1),
                  "corner": (1, 1)}


def is_compute(stagger: str, n: int, h: int, i, j):
    """Whether the storage points (i, j) of a tile (int arrays) are compute
    points of `stagger` (center, x_iface, y_iface or corner)."""
    ei, ej = _COMPUTE_EXTRA[stagger]
    return (i >= h) & (i < h + n + ei) & (j >= h) & (j < h + n + ej)


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

    def part(self, rank: int) -> "RankPart":
        """What `rank` holds (`RankPart`): its `cut` is the `scatter`
        argument of the grid builders, and the part itself the `part`
        argument of the initial-state builders."""
        return RankPart(self, rank)

    def gather(self, parts: Iterable):
        """The global array from every rank's held part (in rank order),
        taken one part at a time: under whole tiles the parts (of any
        trailing shape, such as a compute-domain cut) placed along the
        tile axis at their ranks' tiles; else each rank's owned box
        written into a (6, N, N, ...) array."""
        out = None
        for rank, part in enumerate(parts):
            if out is None:
                shape = ((6,) + tuple(part.shape[1:]) if self.whole_tiles
                         else (6, self.N, self.N) + tuple(part.shape[3:]))
                out = (part.new_empty(shape) if isinstance(part, torch.Tensor)
                       else np.empty(shape, dtype=np.asarray(part).dtype))
            b = self.box(rank)
            if self.whole_tiles:
                out[b.t0:b.t1] = part
                continue
            lb = self.local_box(rank)
            out[b.index] = part[:, b.i0 - lb.i0:b.i1 - lb.i0,
                                b.j0 - lb.j0:b.j1 - lb.j0]
        return out

    def part_shapes(self, trailing: tuple = ()) -> list:
        """The shape of each rank's held part (rank order) of a field with
        `trailing` dimensions after (tile, i, j)."""
        return [self.local_box(rank).shape + tuple(trailing)
                for rank in range(self.size)]


class RankPart:
    """What one rank holds: the block `Partition.local_box(rank)` of the
    padded storage (6, N, N), which held points are compute points of their
    tile (points in another rank's box included), and for each held point
    the source (tile, i, j) that the topology's halo gather reads (for a
    vector component also the source component and sign), computed for the
    held points alone.  The grid (`grid.generation.generate_grid_data`,
    its metric terms evaluated at the block's points and at the halo's
    sources, `grid/points.py`) and the initial state are built from these
    on the block alone; the builders take the whole cube as
    `RankPart.whole`."""

    def __init__(self, partition: Partition, rank: int):
        self.partition, self.rank = partition, rank
        self.box = partition.local_box(rank)
        self.n, self.h, self.N = partition.n, partition.h, partition.N

    @classmethod
    def whole(cls, n: int, h: int = constants.N_HALO_DEFAULT) -> "RankPart":
        """The whole cube, the one part of layout (1, 1, 1)."""
        return cls(Partition((1, 1, 1), n, h), 0)

    @property
    def is_whole(self) -> bool:
        """Whether this part is the whole cube (layout (1, 1, 1))."""
        return self.partition.size == 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.box.shape

    def cut(self, array, axis: Optional[int] = None):
        """This rank's part of a whole-cube array (`Partition.scatter`)."""
        return self.partition.scatter(array, self.rank, axis)

    def indices(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The storage indices (tile, i, j) of every held point, each of
        the block's shape."""
        b = self.box
        return tuple(np.meshgrid(np.arange(b.t0, b.t1),
                                 np.arange(b.i0, b.i1),
                                 np.arange(b.j0, b.j1), indexing="ij"))

    def compute(self, stagger: str = "center") -> np.ndarray:
        """Bool mask of the block: the held compute points of `stagger`."""
        _, i, j = self.indices()
        return is_compute(stagger, self.n, self.h, i, j)

    def scalar_sources(self, stagger: str = "center") -> tuple:
        """(tile, i, j) of the point the halo gather of a `stagger` scalar
        reads for each held point (the point itself outside the halo),
        computed for the held points alone."""
        return get_topology(self.n, self.h).scalar_source_at(
            stagger, *self.indices())

    def vector_sources(self, u_stagger: str, v_stagger: str) -> tuple:
        """For each component of a vector pair, (tile, i, j, comp, sign) of
        each held point: the halo gather reads component `comp` (0 u, 1 v)
        at (tile, i, j) and multiplies it by `sign`."""
        topo = get_topology(self.n, self.h)
        return tuple(topo.vector_source_at(u_stagger, v_stagger, comp,
                                           *self.indices())
                     for comp in (0, 1))
