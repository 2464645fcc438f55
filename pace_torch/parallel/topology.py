"""Cubed-sphere tile topology: adjacency, index transforms, halo gather maps.

Single-device replacement for the reference's MPI-based halo-exchange
stack (ai2cm/pace util/pace/util/partitioner.py:365
`CubedSpherePartitioner`, halo_updater.py:29, rotate.py).  Every field is a
global array `(6, N, N, ...)` and a halo update is a single precomputed
gather: for each halo point we store `(src_tile, src_i, src_j)` (and, for
vectors, a source-component selector and sign).  The tables are numpy and
identical to `pace_tpu.parallel.topology`'s; `parallel/halo.py` moves them
to the device once.

The adjacency and the signed-permutation index transforms between
neighboring tiles are **derived numerically** from the gnomonic cube
geometry (tile edges are matched by corner coincidence), so no rotation
conventions are hand-copied; correctness is checked geometrically in tests.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from pace_torch.grid import gnomonic
from pace_torch.utils import constants
from pace_torch.utils.gridtools import Domain

WEST, EAST, NORTH, SOUTH = (
    constants.WEST, constants.EAST, constants.NORTH, constants.SOUTH,
)

# Edge extraction: corner polyline of edge E of a tile with (n+1)^2 corners,
# parameterized by the along-edge corner index a = 0..n.
_EDGE_SLICERS = {
    WEST: lambda c: c[0, :],
    EAST: lambda c: c[-1, :],
    SOUTH: lambda c: c[:, 0],
    NORTH: lambda c: c[:, -1],
}


def _edge_corner_index(edge: int, a, n: int):
    """(i, j) corner index of the a-th point along edge `edge`."""
    if edge == WEST:
        return np.zeros_like(a), a
    if edge == EAST:
        return np.full_like(a, n), a
    if edge == SOUTH:
        return a, np.zeros_like(a)
    if edge == NORTH:
        return a, np.full_like(a, n)
    raise ValueError(edge)


@dataclasses.dataclass(frozen=True)
class EdgeTransform:
    """Affine signed-permutation map from local extended corner indices to
    the neighbor tile's corner indices: (i', j') = A @ (i, j) + b0 + bn * n.
    """

    neighbor: int
    A: Tuple[Tuple[int, int], Tuple[int, int]]
    b0: Tuple[int, int]
    bn: Tuple[int, int]

    def apply(self, i, j, n: int):
        (a00, a01), (a10, a11) = self.A
        ip = a00 * i + a01 * j + self.b0[0] + self.bn[0] * n
        jp = a10 * i + a11 * j + self.b0[1] + self.bn[1] * n
        return ip, jp

    def apply_float(self, x, y, n: int):
        """Same map on continuous local coordinates (e.g. cell centers)."""
        (a00, a01), (a10, a11) = self.A
        xp = a00 * x + a01 * y + self.b0[0] + self.bn[0] * n
        yp = a10 * x + a11 * y + self.b0[1] + self.bn[1] * n
        return xp, yp

    @property
    def a_matrix(self) -> np.ndarray:
        return np.array(self.A, dtype=np.int64)


def _match_edges(corners: np.ndarray, n: int):
    """For each (tile, edge) find (neighbor_tile, neighbor_edge, orient).

    orient=+1 if the along-edge corner parameterizations run in the same
    direction, -1 if reversed.
    """
    matches = {}
    tol = 1e-9
    for t in range(6):
        for e in (WEST, EAST, NORTH, SOUTH):
            line = _EDGE_SLICERS[e](corners[t])
            found = None
            for t2 in range(6):
                if t2 == t:
                    continue
                for e2 in (WEST, EAST, NORTH, SOUTH):
                    line2 = _EDGE_SLICERS[e2](corners[t2])
                    if np.allclose(line, line2, atol=tol):
                        found = (t2, e2, +1)
                    elif np.allclose(line, line2[::-1], atol=tol):
                        found = (t2, e2, -1)
                    if found:
                        break
                if found:
                    break
            if not found:
                raise RuntimeError(f"no neighbor found for tile {t} edge {e}")
            matches[(t, e)] = found
    return matches


def _solve_transform(edge: int, match, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Solve (A, b) for one edge at a specific n from the corner-point
    correspondence plus the outward-normal condition."""
    t2, e2, orient = match
    a = np.arange(n + 1)
    li, lj = _edge_corner_index(edge, a, n)
    a2 = a if orient == 1 else n - a
    ni, nj = _edge_corner_index(e2, a2, n)

    # along-edge direction condition from two corner correspondences
    d_local = np.array([li[1] - li[0], lj[1] - lj[0]])
    d_nbr = np.array([ni[1] - ni[0], nj[1] - nj[0]])
    # outward normal of local edge maps to inward normal of neighbor edge
    out_local = {
        WEST: np.array([-1, 0]), EAST: np.array([1, 0]),
        SOUTH: np.array([0, -1]), NORTH: np.array([0, 1]),
    }[edge]
    in_nbr = -{
        WEST: np.array([-1, 0]), EAST: np.array([1, 0]),
        SOUTH: np.array([0, -1]), NORTH: np.array([0, 1]),
    }[e2]

    # A maps d_local -> d_nbr and out_local -> in_nbr
    M_local = np.stack([d_local, out_local], axis=1)  # 2x2
    M_nbr = np.stack([d_nbr, in_nbr], axis=1)
    A = M_nbr @ np.linalg.inv(M_local)
    A = np.rint(A).astype(np.int64)
    b = np.array([ni[0], nj[0]]) - A @ np.array([li[0], lj[0]])
    return A, b


@functools.lru_cache(maxsize=None)
def edge_transforms() -> Dict[Tuple[int, int], EdgeTransform]:
    """Derive all 24 (tile, edge) transforms, with b expressed as b0 + bn*n."""
    out = {}
    n_a, n_b = 4, 8
    corners_a = gnomonic.cube_corners(n_a)
    corners_b = gnomonic.cube_corners(n_b)
    matches_a = _match_edges(corners_a, n_a)
    matches_b = _match_edges(corners_b, n_b)
    if {k: v for k, v in matches_a.items()} != matches_b:
        raise RuntimeError("edge matching is grid-size dependent; bug")
    for key, match in matches_a.items():
        t, e = key
        A_a, b_a = _solve_transform(e, match, n_a)
        A_b, b_b = _solve_transform(e, match, n_b)
        if not np.array_equal(A_a, A_b):
            raise RuntimeError("transform matrix is grid-size dependent; bug")
        bn = (b_b - b_a) // (n_b - n_a)
        b0 = b_a - bn * n_a
        out[key] = EdgeTransform(
            neighbor=match[0],
            A=tuple(map(tuple, A_a.tolist())),
            b0=tuple(b0.tolist()),
            bn=tuple(bn.tolist()),
        )
    return out


# ---------------------------------------------------------------------------
# Gather-map construction
# ---------------------------------------------------------------------------

# staggering: (x_offset, y_offset) of the point location within the cell grid
# in units of cells; centers are at +0.5, interfaces at 0.0
_STAGGER_OFFSETS = {
    "center": (0.5, 0.5),
    "x_iface": (0.0, 0.5),   # C-grid u / D-grid v points: (n+1, n)
    "y_iface": (0.5, 0.0),   # C-grid v / D-grid u points: (n, n+1)
    "corner": (0.0, 0.0),    # B-grid points: (n+1, n+1)
}


def _region_of(x, y, n, halo):
    """Which halo region a continuous local point (x, y) falls in.

    Returns an integer array: 0 interior/compute/padding, 1..4 = W/E/S/N edge
    halo, 5 = corner wedge (diagonal, no unique source tile).  Points beyond
    the halo band (alignment padding) are treated as interior (identity map).
    """
    in_band = (x >= -halo) & (x <= n + halo) & (y >= -halo) & (y <= n + halo)
    west = (x < 0) & in_band
    east = (x > n) & in_band
    south = (y < 0) & in_band
    north = (y > n) & in_band
    edge_count = (
        west.astype(int) + east.astype(int) + south.astype(int)
        + north.astype(int)
    )
    region = np.zeros(np.shape(x), dtype=np.int64)
    region[west] = 1
    region[east] = 2
    region[south] = 3
    region[north] = 4
    region[edge_count > 1] = 5
    return region


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Precomputed gather map for one staggering/vector kind. All index
    arrays have the full storage shape (6, N, N)."""

    kind: str
    src_tile: np.ndarray
    src_i: np.ndarray
    src_j: np.ndarray
    # for vectors: which source component (0=u-like, 1=v-like) and sign
    src_comp: np.ndarray | None = None
    sign: np.ndarray | None = None
    valid: np.ndarray | None = None  # False in corner wedges
    _device_copies: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def on(self, device) -> dict:
        """The gather tables as tensors on `device`, built once per device:
        int64 indices t/i/j (and comp), float32 sign."""
        device = torch.device(device)
        if device not in self._device_copies:
            def idx(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            out = dict(t=idx(self.src_tile), i=idx(self.src_i),
                       j=idx(self.src_j))
            if self.src_comp is not None:
                out["comp"] = idx(self.src_comp)
                out["sign"] = torch.as_tensor(np.asarray(self.sign),
                                              device=device)
            self._device_copies[device] = out
        return self._device_copies[device]


class CubedSphereTopology:
    """Halo gather maps for a given tile size n and halo width.

    Storage convention: arrays (6, N, N, ...) with N = n + 2*halo + 1;
    cell (i, j) at [i+halo, j+halo], interface index i at [i+halo].
    """

    def __init__(self, n: int, halo: int = constants.N_HALO_DEFAULT):
        self.n = n
        self.halo = halo
        # storage padded to a multiple of 8, as in the reference package
        self.N = -(-(n + 2 * halo + 1) // 8) * 8
        self.transforms = edge_transforms()
        self._specs: Dict[str, HaloSpec] = {}

    @property
    def domain(self) -> Domain:
        """The operators' index space: the whole tile."""
        return Domain.whole(self.n, self.halo)

    # -- public API --------------------------------------------------------
    def scalar_spec(self, stagger: str = "center") -> HaloSpec:
        if stagger not in ("center", "corner"):
            raise ValueError(
                "lone scalar halo updates are only well-defined for "
                "rotation-invariant staggerings (center, corner); "
                f"got {stagger!r} — exchange x/y-interface fields as pairs "
                "via vector_spec / halo_update_staggered_pair"
            )
        key = f"scalar:{stagger}"
        if key not in self._specs:
            self._specs[key] = self._build_scalar(stagger)
        return self._specs[key]

    def scalar_corner_specs(self) -> Tuple[HaloSpec, HaloSpec]:
        """Halo exchange composed with the FvTp2d corner copies as single
        gather maps: (halo ∘ copy_corners_y, halo ∘ copy_corners_y ∘
        copy_corners_x).  The transport path consumes these directly so a
        halo-update + two corner fills costs two gathers instead of three,
        with no serial dependency between them."""
        key = "scalar:center+corners"
        if key not in self._specs:
            from pace_torch.ops.corners import copy_corners_perm

            spec = self.scalar_spec("center")
            T = np.asarray(spec.src_tile)
            I = np.asarray(spec.src_i)
            J = np.asarray(spec.src_j)
            SIy, SJy = copy_corners_perm(self.domain, "y")
            Ty, Iy, Jy = T[:, SIy, SJy], I[:, SIy, SJy], J[:, SIy, SJy]
            SIx, SJx = copy_corners_perm(self.domain, "x")
            self._specs[key] = (
                HaloSpec("scalar:center+corner_y", Ty, Iy, Jy),
                HaloSpec(
                    "scalar:center+corner_y+corner_x",
                    Ty[:, SIx, SJx], Iy[:, SIx, SJx], Jy[:, SIx, SJx],
                ),
            )
        return self._specs[key]

    def vector_spec(self, u_stagger: str, v_stagger: str) -> Tuple[HaloSpec, HaloSpec]:
        """Specs for the two components of a vector field.

        u is the x-directed component with staggering `u_stagger`, v the
        y-directed component.  D-grid winds: u_stagger="y_iface",
        v_stagger="x_iface".  C-grid: u="x_iface", v="y_iface".
        A-grid: both "center".
        """
        key = f"vector:{u_stagger}:{v_stagger}"
        if key not in self._specs:
            self._specs[key] = self._build_vector(u_stagger, v_stagger)
        return self._specs[key]

    def reduce_max(self, value: torch.Tensor) -> torch.Tensor:
        """The maximum over every rank: one rank holds the whole cube."""
        return value

    # -- construction -------------------------------------------------------
    def _point_coords(self, stagger: str):
        """Continuous local coordinates (x, y) of every storage point, plus
        the storage index grids (I, J)."""
        ox, oy = _STAGGER_OFFSETS[stagger]
        I, J = np.meshgrid(np.arange(self.N), np.arange(self.N), indexing="ij")
        x = I - self.halo + ox
        y = J - self.halo + oy
        return x, y, I, J

    def _source_point(self, t: int, region: np.ndarray, x, y):
        """Map local continuous points to (src_tile, x', y') using the edge
        transform for their region. Returns arrays; wedge/interior points map
        to themselves."""
        src_t = np.full(x.shape, t, dtype=np.int64)
        xp = x.copy()
        yp = y.copy()
        for region_id, edge in ((1, WEST), (2, EAST), (3, SOUTH), (4, NORTH)):
            mask = region == region_id
            if not mask.any():
                continue
            tr = self.transforms[(t, edge)]
            xe, ye = tr.apply_float(x[mask], y[mask], self.n)
            xp[mask] = xe
            yp[mask] = ye
            src_t[mask] = tr.neighbor
        return src_t, xp, yp

    def _build_scalar(self, stagger: str) -> HaloSpec:
        ox, oy = _STAGGER_OFFSETS[stagger]
        specs_t, specs_i, specs_j, valid = [], [], [], []
        for t in range(6):
            x, y, I, J = self._point_coords(stagger)
            region = _region_of(x, y, self.n, self.halo)
            src_t, xp, yp = self._source_point(t, region, x, y)
            # back to storage indices in the source tile
            si = np.rint(xp - ox).astype(np.int64) + self.halo
            sj = np.rint(yp - oy).astype(np.int64) + self.halo
            fill = (region >= 1) & (region <= 4)
            si = np.where(fill, si, I)
            sj = np.where(fill, sj, J)
            st = np.where(fill, src_t, t)
            ok = region != 5
            # guard: all source indices in range
            assert si.min() >= 0 and si.max() < self.N
            assert sj.min() >= 0 and sj.max() < self.N
            specs_t.append(st); specs_i.append(si); specs_j.append(sj)
            valid.append(ok)
        return HaloSpec(
            kind=f"scalar:{stagger}",
            src_tile=np.stack(specs_t).astype(np.int32),
            src_i=np.stack(specs_i).astype(np.int32),
            src_j=np.stack(specs_j).astype(np.int32),
            valid=np.stack(valid),
        )

    def _build_vector(self, u_stagger: str, v_stagger: str) -> HaloSpec:
        """Build the gather map for the u component of a (u, v) vector pair;
        the v component spec is built by `vector_spec` symmetrically and both
        are returned together.

        The local u halo value comes from the neighbor's u or v array
        depending on the rotation: with A the local->neighbor index
        transform, local unit vector e_x maps to neighbor direction
        A @ e_x, so u_local = sum_k (A)[k,0] * comp'_k evaluated at the
        transformed point (A is a signed permutation, so exactly one k).
        """
        u_spec = self._build_vector_component(u_stagger, v_stagger, comp=0)
        v_spec = self._build_vector_component(u_stagger, v_stagger, comp=1)
        return (u_spec, v_spec)

    def _build_vector_component(self, u_stagger, v_stagger, comp: int) -> HaloSpec:
        stagger = u_stagger if comp == 0 else v_stagger
        ox, oy = _STAGGER_OFFSETS[stagger]
        u_off = _STAGGER_OFFSETS[u_stagger]
        v_off = _STAGGER_OFFSETS[v_stagger]
        all_t, all_i, all_j, all_c, all_s, valid = [], [], [], [], [], []
        for t in range(6):
            x, y, I, J = self._point_coords(stagger)
            region = _region_of(x, y, self.n, self.halo)
            src_t = np.full(x.shape, t, dtype=np.int64)
            si = I.copy(); sj = J.copy()
            sc = np.full(x.shape, comp, dtype=np.int64)
            sg = np.ones(x.shape)
            for region_id, edge in ((1, WEST), (2, EAST), (3, SOUTH), (4, NORTH)):
                mask = region == region_id
                if not mask.any():
                    continue
                tr = self.transforms[(t, edge)]
                A = tr.a_matrix
                xp, yp = tr.apply_float(x[mask], y[mask], self.n)
                # direction of the local component in neighbor frame
                local_dir = np.array([1, 0]) if comp == 0 else np.array([0, 1])
                nbr_dir = A @ local_dir  # signed unit vector
                if nbr_dir[0] != 0:
                    nbr_comp, sign = 0, int(nbr_dir[0])
                    noff = u_off
                else:
                    nbr_comp, sign = 1, int(nbr_dir[1])
                    noff = v_off
                ii = np.rint(xp - noff[0]).astype(np.int64) + self.halo
                jj = np.rint(yp - noff[1]).astype(np.int64) + self.halo
                # verify the transformed points land exactly on the source
                # staggering (sanity check of the staggering algebra)
                assert np.allclose(xp - noff[0], np.rint(xp - noff[0]))
                assert np.allclose(yp - noff[1], np.rint(yp - noff[1]))
                si[mask] = ii
                sj[mask] = jj
                src_t[mask] = tr.neighbor
                sc[mask] = nbr_comp
                sg[mask] = sign
            ok = region != 5
            assert si.min() >= 0 and si.max() < self.N
            assert sj.min() >= 0 and sj.max() < self.N
            all_t.append(src_t); all_i.append(si); all_j.append(sj)
            all_c.append(sc); all_s.append(sg); valid.append(ok)
        return HaloSpec(
            kind=f"vector{comp}:{u_stagger}:{v_stagger}",
            src_tile=np.stack(all_t).astype(np.int32),
            src_i=np.stack(all_i).astype(np.int32),
            src_j=np.stack(all_j).astype(np.int32),
            src_comp=np.stack(all_c).astype(np.int32),
            sign=np.stack(all_s).astype(np.float32),
            valid=np.stack(valid),
        )

    # -- interface-edge ownership -------------------------------------------
    @functools.lru_cache(maxsize=None)
    def interface_sync_map(self, u_stagger: str, v_stagger: str):
        """Maps to synchronize edge-shared interface points of a vector pair.

        For interface-staggered components, the points exactly on a shared
        tile edge exist in both tiles' compute domains.  Following the
        reference convention (communicator.py:472-519), each tile pulls the
        value from its WEST and SOUTH edge-sharing neighbor, i.e. values on
        a tile's west/south compute-domain boundary lines are overwritten
        with the neighbor's copy when the neighbor is east/north-owning.
        We adopt the convention: the point value is owned by the tile for
        which it lies on the EAST or NORTH boundary; west/south copies are
        overwritten.  Returns (u_map, v_map) like vector specs but only
        differing from identity on the shared lines.
        """
        return (
            self._build_interface_sync(u_stagger, v_stagger, comp=0),
            self._build_interface_sync(u_stagger, v_stagger, comp=1),
        )

    def _build_interface_sync(self, u_stagger, v_stagger, comp: int) -> HaloSpec:
        stagger = u_stagger if comp == 0 else v_stagger
        ox, oy = _STAGGER_OFFSETS[stagger]
        u_off = _STAGGER_OFFSETS[u_stagger]
        v_off = _STAGGER_OFFSETS[v_stagger]
        all_t, all_i, all_j, all_c, all_s = [], [], [], [], []
        n = self.n
        for t in range(6):
            x, y, I, J = self._point_coords(stagger)
            src_t = np.full(x.shape, t, dtype=np.int64)
            si = I.copy(); sj = J.copy()
            sc = np.full(x.shape, comp, dtype=np.int64)
            sg = np.ones(x.shape)
            # which shared lines does this staggering have? x==0 (west) when
            # ox==0; y==0 (south) when oy==0
            lines = []
            if ox == 0.0:
                lines.append((WEST, (x == 0) & (y >= 0) & (y <= n)))
            if oy == 0.0:
                lines.append((SOUTH, (y == 0) & (x >= 0) & (x <= n)))
            for edge, mask in lines:
                if not mask.any():
                    continue
                tr = self.transforms[(t, edge)]
                A = tr.a_matrix
                xp, yp = tr.apply_float(x[mask], y[mask], n)
                local_dir = np.array([1, 0]) if comp == 0 else np.array([0, 1])
                nbr_dir = A @ local_dir
                if nbr_dir[0] != 0:
                    nbr_comp, sign = 0, int(nbr_dir[0])
                    noff = u_off
                else:
                    nbr_comp, sign = 1, int(nbr_dir[1])
                    noff = v_off
                ii = np.rint(xp - noff[0]).astype(np.int64) + self.halo
                jj = np.rint(yp - noff[1]).astype(np.int64) + self.halo
                si[mask] = ii; sj[mask] = jj
                src_t[mask] = tr.neighbor
                sc[mask] = nbr_comp
                sg[mask] = sign
            all_t.append(src_t); all_i.append(si); all_j.append(sj)
            all_c.append(sc); all_s.append(sg)
        return HaloSpec(
            kind=f"ifsync{comp}:{u_stagger}:{v_stagger}",
            src_tile=np.stack(all_t).astype(np.int32),
            src_i=np.stack(all_i).astype(np.int32),
            src_j=np.stack(all_j).astype(np.int32),
            src_comp=np.stack(all_c).astype(np.int32),
            sign=np.stack(all_s).astype(np.float32),
        )


@functools.lru_cache(maxsize=8)
def get_topology(n: int, halo: int = constants.N_HALO_DEFAULT) -> CubedSphereTopology:
    return CubedSphereTopology(n, halo)
