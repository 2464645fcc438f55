"""Cubed-sphere metric-term generation (init-time, numpy float64).

Whole-tile derivation of the reference MetricTerms: every quantity is
computed for all six tiles at once on padded global storage (6, N, N, ...),
with halo exchange through the topology gather maps and cube-corner wedge
handling through the same index tables the runtime uses.  The numpy
arithmetic is that of `pace_tpu.grid.generation` line for line, so the two
packages build bit-identical metrics.

Output is `GridData`, a bundle of torch tensors on an explicit device and
dtype, consumed by the dycore.  A rank of a multi-rank run builds only its
block (`generate_grid_data(..., part=...)`): the same terms evaluated at
the block's points and at the points its halo is filled from
(grid/points.py), never the whole cube's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pace_torch.grid import eta, geometry, gnomonic
from pace_torch.ops import corners as corner_ops
from pace_torch.parallel.topology import get_topology
from pace_torch.utils.constants import N_HALO_DEFAULT, OMEGA, PI, RADIUS

BIG_NUMBER = 1.0e8
TINY_NUMBER = 1.0e-8


# ---------------------------------------------------------------------------
# numpy halo helpers (same gather maps the runtime uses)
# ---------------------------------------------------------------------------

def _halo_scalar_np(topo, q, stagger="center"):
    spec = topo.scalar_spec(stagger)
    st = np.asarray(spec.src_tile)
    si = np.asarray(spec.src_i)
    sj = np.asarray(spec.src_j)
    return q[st, si, sj]


def _halo_pair_np(topo, a_u, a_v, u_stagger, v_stagger, signed=False):
    u_spec, v_spec = topo.vector_spec(u_stagger, v_stagger)
    outs = []
    for spec in (u_spec, v_spec):
        st = np.asarray(spec.src_tile)
        si = np.asarray(spec.src_i)
        sj = np.asarray(spec.src_j)
        sc = np.asarray(spec.src_comp)
        from_u = a_u[st, si, sj]
        from_v = a_v[st, si, sj]
        out = np.where((sc == 0)[..., *([None] * (a_u.ndim - 3))], from_u, from_v)
        if signed:
            sg = np.asarray(spec.sign)
            out = out * sg.reshape(sg.shape + (1,) * (a_u.ndim - 3))
        outs.append(out)
    return outs[0], outs[1]


def _fill_corners_2d_np(q, n, h, gridtype, direction):
    ti, tj, si, sj = map(np.asarray, corner_ops._fill_corners_2d_table(
        n, h, gridtype, direction))
    q = q.copy()
    q[:, ti, tj] = q[:, si, sj]
    return q


def _fill_corners_vector_np(x, y, n, h, grid, vector=False):
    tables = corner_ops._fill_corners_vector_tables(n, h, grid)
    mysign = -1.0 if vector else 1.0
    outs = []
    for tgt_arr, arr in ((0, x), (1, y)):
        ti, tj, si, sj, sa, sg = map(np.asarray, tables[tgt_arr])
        from_x = x[:, si, sj]
        from_y = y[:, si, sj]
        extra = (1,) * (x.ndim - 3)
        vals = np.where((sa == 0).reshape(sa.shape + extra), from_x, from_y)
        sign = np.where((sg == 1).reshape(sg.shape + extra), mysign, 1.0)
        out = arr.copy()
        out[:, ti, tj] = sign * vals
        outs.append(out)
    return outs[0], outs[1]


# ---------------------------------------------------------------------------
# Grid data bundles (tensors)
# ---------------------------------------------------------------------------

# The axis of the tile each (6, N) edge table runs along: j (2) on the west
# and east edges, i (1) on the south and north ones.
EDGE_TABLE_AXIS = {f"{kind}_{side}": 2 if side in "we" else 1
                   for kind in ("edge", "edge_vect") for side in "wesn"}


def _tensor_bundle(cls, arrays: dict, device, dtype, scatter=None):
    """Build a bundle dataclass: array fields become tensors on `device`
    with `dtype`, cut by `scatter` where given (a (6, N) edge table along
    its own axis); scalar fields stay Python numbers."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        if f.type in ("float", "int"):
            kw[f.name] = type(0.0 if f.type == "float" else 0)(v)
        else:
            v = np.asarray(v)
            if scatter is not None:
                v = (scatter(v, axis=EDGE_TABLE_AXIS[f.name]) if v.ndim == 2
                     else scatter(v))
            kw[f.name] = torch.tensor(v, dtype=dtype, device=device)
    return cls(**kw)


@dataclasses.dataclass
class HorizontalGridData:
    lon: torch.Tensor          # corner longitudes (6, N, N)
    lat: torch.Tensor
    lon_agrid: torch.Tensor    # cell-center longitudes
    lat_agrid: torch.Tensor
    area: torch.Tensor
    rarea: torch.Tensor
    area_c: torch.Tensor
    rarea_c: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dxc: torch.Tensor
    dyc: torch.Tensor
    dxa: torch.Tensor
    dya: torch.Tensor
    rdx: torch.Tensor
    rdy: torch.Tensor
    rdxc: torch.Tensor
    rdyc: torch.Tensor
    rdxa: torch.Tensor
    rdya: torch.Tensor
    a11: torch.Tensor
    a12: torch.Tensor
    a21: torch.Tensor
    a22: torch.Tensor
    edge_w: torch.Tensor       # (6, N) along y-interfaces
    edge_e: torch.Tensor
    edge_s: torch.Tensor       # (6, N) along x-interfaces
    edge_n: torch.Tensor
    edge_vect_w: torch.Tensor  # (6, N) along y-cells
    edge_vect_e: torch.Tensor
    edge_vect_s: torch.Tensor
    edge_vect_n: torch.Tensor
    ec1: torch.Tensor          # (6, N, N, 3) unit vectors at centers
    ec2: torch.Tensor
    ew1: torch.Tensor          # at x-interfaces (west/east cell edges)
    ew2: torch.Tensor
    es1: torch.Tensor          # at y-interfaces (south/north cell edges)
    es2: torch.Tensor
    ee1: torch.Tensor          # at corners
    ee2: torch.Tensor
    vlon: torch.Tensor         # eastward unit vector at centers
    vlat: torch.Tensor
    z11: torch.Tensor
    z12: torch.Tensor
    z21: torch.Tensor
    z22: torch.Tensor
    l2c_u: torch.Tensor
    l2c_v: torch.Tensor
    fC: torch.Tensor           # Coriolis parameter at corners
    f0: torch.Tensor           # Coriolis parameter at centers


@dataclasses.dataclass
class AngleGridData:
    cos_sg: torch.Tensor   # (6, N, N, 9) supergrid angles; [..., 4] is center
    sin_sg: torch.Tensor
    cosa: torch.Tensor     # at corners
    sina: torch.Tensor
    cosa_u: torch.Tensor
    cosa_v: torch.Tensor
    cosa_s: torch.Tensor
    sina_u: torch.Tensor
    sina_v: torch.Tensor
    rsina: torch.Tensor
    rsin_u: torch.Tensor
    rsin_v: torch.Tensor
    rsin2: torch.Tensor


@dataclasses.dataclass
class DampingCoefficients:
    divg_u: torch.Tensor
    divg_v: torch.Tensor
    del6_u: torch.Tensor
    del6_v: torch.Tensor
    da_min: float
    da_min_c: float
    da_max: float
    da_max_c: float


@dataclasses.dataclass
class VerticalGridData:
    ak: torch.Tensor
    bk: torch.Tensor
    ks: int
    ptop: float
    p_ref: float = 1.0e5


_BUNDLES = (
    ("horizontal", HorizontalGridData),
    ("angle", AngleGridData),
    ("damping", DampingCoefficients),
    ("vertical", VerticalGridData),
)

# the terms of each horizontal bundle that are (6, N, N[, ...]) point
# fields: every array leaf but the edge tables
POINT_TERMS = {
    name: [f.name for f in dataclasses.fields(bcls)
           if f.type not in ("float", "int") and f.name not in EDGE_TABLE_AXIS]
    for name, bcls in _BUNDLES[:3]
}


@dataclasses.dataclass
class GridData:
    horizontal: HorizontalGridData
    angle: AngleGridData
    damping: DampingCoefficients
    vertical: VerticalGridData
    device: torch.device
    dtype: torch.dtype

    @classmethod
    def from_numpy(cls, arrays: dict, device, dtype,
                   scatter=None) -> "GridData":
        """Build from nested numpy leaves {bundle: {field: array or
        scalar}} -- the layout of `pace_tpu`'s GridData, so both packages
        can be fed identical metrics.  With `scatter`
        (`Partition.part(rank).cut`) the horizontal bundles hold one rank's
        part; the scalars (da_min, ...) stay those of the whole cube."""
        kw = {
            name: _tensor_bundle(bcls, arrays[name], device, dtype,
                                 None if name == "vertical" else scatter)
            for name, bcls in _BUNDLES
        }
        # the tensors' own device: "cuda" resolves to "cuda:<index>"
        return cls(**kw, device=kw["horizontal"].area.device, dtype=dtype)

    def scattered(self, scatter) -> "GridData":
        """This (whole cube's) grid cut by `scatter`
        (`Partition.part(rank).cut`), as `from_numpy` cuts it: contiguous
        copies, as the kernels take them."""
        def cut(bundle):
            kw = {}
            for f in dataclasses.fields(bundle):
                v = getattr(bundle, f.name)
                if isinstance(v, torch.Tensor):
                    v = (scatter(v, axis=EDGE_TABLE_AXIS[f.name])
                         if v.ndim == 2 else scatter(v)).contiguous()
                kw[f.name] = v
            return type(bundle)(**kw)

        return dataclasses.replace(
            self, horizontal=cut(self.horizontal), angle=cut(self.angle),
            damping=cut(self.damping))


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _conv(x):
    """Padded/undefined cells of some metric terms (agrid-derived fields,
    outermost divg/del6 lines) hold NaN from the numpy generation; they are
    never consumed by the dycore, but any reachable NaN poisons 0*NaN
    products and float32 casts.  Replace with a benign finite value and
    clamp to the float32 range."""
    x = np.nan_to_num(x, nan=1.0, posinf=1.0e30, neginf=-1.0e30)
    return np.clip(x, -1.0e30, 1.0e30)


def _grid_arrays(terms: dict, vertical, extremes: dict) -> dict:
    """The nested numpy leaves `GridData.from_numpy` takes, from the raw
    float64 terms of each bundle."""
    return {
        "horizontal": {k: _conv(v) for k, v in terms["horizontal"].items()},
        "angle": {k: _conv(v) for k, v in terms["angle"].items()},
        "damping": {
            **{k: _conv(terms["damping"][k])
               for k in ("divg_u", "divg_v", "del6_u", "del6_v")},
            **{k: float(extremes[k])
               for k in ("da_min", "da_min_c", "da_max", "da_max_c")},
        },
        "vertical": dict(ak=vertical.ak, bk=vertical.bk, ks=vertical.ks,
                         ptop=vertical.ptop, p_ref=1.0e5),
    }


def _part_terms(part, stretch_factor, lon_target, lat_target) -> tuple:
    """The raw terms of the block `part` holds (edge tables cut as
    `part.cut` cuts them) and the whole cube's four area extremes,
    evaluated at the block's points (grid/points.py)."""
    from pace_torch.grid import points

    n, h, N = part.n, part.h, part.N
    metrics = points.PointMetrics(n, h, stretch_factor, lon_target,
                                  lat_target)
    t, i, j = part.indices()
    terms = {bundle: {name: metrics.term(name, t, i, j) for name in names}
             for bundle, names in POINT_TERMS.items()}
    tiles = np.arange(part.box.t0, part.box.t1)
    tt, kk = np.meshgrid(tiles, np.arange(N), indexing="ij")
    for name in EDGE_TABLE_AXIS:
        table = np.zeros((6, N))
        table[tiles] = metrics.edge(name, tt, kk)
        terms["horizontal"][name] = part.cut(table,
                                             axis=EDGE_TABLE_AXIS[name])
    extremes = points.area_extremes(n, h, *_grid_key(
        stretch_factor, lon_target, lat_target))
    return terms, extremes


def grid_arrays_numpy(n: int, nz: int, halo: int = N_HALO_DEFAULT,
                      stretch_factor: float = None,
                      lon_target: float = 350.0, lat_target: float = -90.0,
                      eta_file: str = None, part=None) -> dict:
    """The nested numpy leaves `GridData.from_numpy` takes, float64: of
    the whole cube, or of the block `part` (`Partition.part(rank)`) holds,
    built on that block alone and equal to the whole cube's cut to it bit
    for bit (the four area extremes are the whole cube's)."""
    vertical = eta.set_hybrid_pressure_coefficients(nz, eta_file=eta_file)
    if part is not None and not part.is_whole:
        terms, extremes = _part_terms(part, stretch_factor, lon_target,
                                      lat_target)
        return _grid_arrays(terms, vertical, extremes)
    raw = _generate_metric_terms(
        n, halo, stretch_factor=stretch_factor,
        lon_target=lon_target, lat_target=lat_target,
    )
    return _grid_arrays(raw, vertical, raw["damping"])


def generate_grid_data(n: int, nz: int, halo: int = N_HALO_DEFAULT, *,
                       device="cuda", dtype=torch.float32,
                       stretch_factor: float = None,
                       lon_target: float = 350.0, lat_target: float = -90.0,
                       eta_file: str = None, part=None) -> GridData:
    """Generate the full metric-term bundle for a C`n` grid with `nz`
    levels.  With `part` (`Partition.part(rank)`) only that rank's block
    is built: its metric terms are evaluated at the block's points and at
    the points its halo is filled from (grid/points.py), bit for bit the
    whole cube's grid cut to it (`GridData.scattered`).

    stretch_factor/lon_target/lat_target apply the Schmidt stretched-grid
    transformation (grid/stretch_transformation.py) to the gnomonic grid
    before any metric is derived; eta_file overrides the built-in ak/bk
    tables — the knobs of the reference's GeneratedGridConfig
    (driver/pace/driver/grid.py:82-140)."""
    return GridData.from_numpy(
        grid_arrays_numpy(n, nz, halo, stretch_factor=stretch_factor,
                          lon_target=lon_target, lat_target=lat_target,
                          eta_file=eta_file, part=part),
        device, dtype)


def _grid_key(stretch_factor, lon_target, lat_target) -> tuple:
    """(stretch_factor, lon_target, lat_target) of a distinct grid: an
    unstretched grid ignores the targets."""
    if stretch_factor is None or stretch_factor == 1.0:
        return None, 350.0, -90.0
    return stretch_factor, float(lon_target), float(lat_target)


def _generate_metric_terms(
    n: int, halo: int, stretch_factor: float = None,
    lon_target: float = 350.0, lat_target: float = -90.0,
):
    """The raw float64 metric terms of the whole cube, computed once per
    distinct grid."""
    return _metric_terms(n, halo, *_grid_key(stretch_factor, lon_target,
                                             lat_target))


def raw_metric_terms(n: int, halo: int, part=None):
    """The raw float64 metric terms (unstretched) the initial states read,
    in the nested layout of `_metric_terms`' result: the whole cube's
    arrays, or for a rank's `part` a view that evaluates each term at the
    points it is indexed with (`points.PointView`), so that a rank reads
    the terms at its block and its halo's sources alone."""
    if part is None or part.is_whole:
        return _generate_metric_terms(n, halo)
    from pace_torch.grid import points

    return points.PointView(points.PointMetrics(n, halo))


@functools.lru_cache(maxsize=4)
def _metric_terms(n, halo, stretch_factor, lon_target, lat_target):
    topo = get_topology(n, halo)
    h = halo
    N = topo.N
    mc = n + 2 * h          # number of cell slots in the active region
    M = mc + 1              # number of corner slots
    isc, iec = h, h + n - 1     # first/last compute cell
    ise = h + n                 # last compute interface

    def halo_c(q):
        return _halo_scalar_np(topo, q, "center")

    def halo_b(q):
        return _halo_scalar_np(topo, q, "corner")

    # ---- 1. D-grid corner lon/lat -------------------------------------
    lon_c, lat_c = gnomonic.cube_corners_lonlat(n)
    # shift the corner away from Japan (reference generation.py:1604-1610)
    lon_c = lon_c - PI / 18.0
    lon_c = np.where(lon_c < 0, lon_c + 2 * PI, lon_c)
    if stretch_factor is not None:
        # Schmidt stretch on the D-grid corners; every metric below is
        # derived from these, so the transform propagates everywhere
        # (reference driver/pace/driver/grid.py:109 + generation.py)
        from pace_torch.grid.stretch_transformation import direct_transform

        lon_c, lat_c = direct_transform(
            lon=lon_c, lat=lat_c, stretch_factor=stretch_factor,
            lon_target=lon_target, lat_target=lat_target,
        )
    grid = np.zeros((6, N, N, 2))
    grid[:, h:h + n + 1, h:h + n + 1, 0] = lon_c
    grid[:, h:h + n + 1, h:h + n + 1, 1] = lat_c
    grid[np.abs(grid) < 1e-10] = 0.0
    grid = _halo_scalar_np(topo, grid, "corner")
    grid = _fill_corners_2d_np(grid, n, h, "B", "x")
    lon = grid[..., 0]
    lat = grid[..., 1]
    dgrid_xyz = geometry.lonlat_to_xyz(lon, lat)

    # ---- 2. A-grid (cell centers) --------------------------------------
    agrid = np.full((6, N, N, 2), np.nan)
    center_xyz = gnomonic.xyz_midpoint(
        dgrid_xyz[:, :M - 1, :M - 1], dgrid_xyz[:, 1:M, :M - 1],
        dgrid_xyz[:, :M - 1, 1:M], dgrid_xyz[:, 1:M, 1:M],
    )
    aglon, aglat = geometry.xyz_to_lonlat(center_xyz)
    agrid[:, :M - 1, :M - 1, 0] = aglon
    agrid[:, :M - 1, :M - 1, 1] = aglat
    agrid = _halo_scalar_np(topo, agrid, "center")
    agrid[..., 0:1] = _fill_corners_2d_np(agrid[..., 0:1], n, h, "A", "x")
    agrid[..., 1:2] = _fill_corners_2d_np(agrid[..., 1:2], n, h, "A", "y")
    lon_agrid = agrid[..., 0]
    lat_agrid = agrid[..., 1]
    agrid_xyz = geometry.lonlat_to_xyz(lon_agrid, lat_agrid)

    # ---- 3. dx / dy ------------------------------------------------------
    dx = np.zeros((6, N, N))
    dy = np.zeros((6, N, N))
    dx[:, :M - 1, :M] = geometry.great_circle_distance_lon_lat(
        lon[:, :M - 1, :M], lon[:, 1:M, :M],
        lat[:, :M - 1, :M], lat[:, 1:M, :M], RADIUS,
    )
    dy[:, :M, :M - 1] = geometry.great_circle_distance_lon_lat(
        lon[:, :M, :M - 1], lon[:, :M, 1:M],
        lat[:, :M, :M - 1], lat[:, :M, 1:M], RADIUS,
    )
    dx, dy = _halo_pair_np(topo, dx, dy, "y_iface", "x_iface")
    dx, dy = np.abs(dx), np.abs(dy)
    dx, dy = _fill_corners_vector_np(dx, dy, n, h, "D", vector=False)

    # ---- 4. dxa / dya (A-grid spacings) ---------------------------------
    dxa = np.zeros((6, N, N))
    dya = np.zeros((6, N, N))
    # midpoints of cell edges
    ymid = gnomonic.xyz_midpoint(dgrid_xyz[:, :M, :M - 1], dgrid_xyz[:, :M, 1:M])
    xmid = gnomonic.xyz_midpoint(dgrid_xyz[:, :M - 1, :M], dgrid_xyz[:, 1:M, :M])
    dxa[:, :M - 1, :M - 1] = geometry.great_circle_distance_xyz(
        ymid[:, :M - 1], ymid[:, 1:M], RADIUS
    )
    dya[:, :M - 1, :M - 1] = geometry.great_circle_distance_xyz(
        xmid[:, :, :M - 1], xmid[:, :, 1:M], RADIUS
    )
    dxa, dya = _fill_corners_vector_np(dxa, dya, n, h, "A", vector=False)
    dxa, dya = _halo_pair_np(topo, dxa, dya, "center", "center")
    dxa, dya = np.abs(dxa), np.abs(dya)

    # ---- 5. dxc / dyc (C-grid center-to-center spacings) ----------------
    dxc = np.zeros((6, N, N))
    dyc = np.zeros((6, N, N))
    dxc[:, 1:M - 1, :M - 1] = geometry.great_circle_distance_xyz(
        agrid_xyz[:, :M - 2, :M - 1], agrid_xyz[:, 1:M - 1, :M - 1], RADIUS
    )
    dxc[:, 0, :M - 1] = dxc[:, 1, :M - 1]
    dxc[:, M - 1, :M - 1] = dxc[:, M - 2, :M - 1]
    dyc[:, :M - 1, 1:M - 1] = geometry.great_circle_distance_xyz(
        agrid_xyz[:, :M - 1, :M - 2], agrid_xyz[:, :M - 1, 1:M - 1], RADIUS
    )
    dyc[:, :M - 1, 0] = dyc[:, :M - 1, 1]
    dyc[:, :M - 1, M - 1] = dyc[:, :M - 1, M - 2]
    # tile-border overrides: distance edge-midpoint <-> first center, doubled
    wmid = gnomonic.xyz_midpoint(
        dgrid_xyz[:, isc, h:h + n], dgrid_xyz[:, isc, h + 1:h + n + 1]
    )
    dxc[:, isc, h:h + n] = 2.0 * geometry.great_circle_distance_xyz(
        wmid, agrid_xyz[:, isc, h:h + n], RADIUS
    )
    emid = gnomonic.xyz_midpoint(
        dgrid_xyz[:, ise, h:h + n], dgrid_xyz[:, ise, h + 1:h + n + 1]
    )
    dxc[:, ise, h:h + n] = 2.0 * geometry.great_circle_distance_xyz(
        emid, agrid_xyz[:, ise - 1, h:h + n], RADIUS
    )
    smid = gnomonic.xyz_midpoint(
        dgrid_xyz[:, h:h + n, isc], dgrid_xyz[:, h + 1:h + n + 1, isc]
    )
    dyc[:, h:h + n, isc] = 2.0 * geometry.great_circle_distance_xyz(
        smid, agrid_xyz[:, h:h + n, isc], RADIUS
    )
    nmid = gnomonic.xyz_midpoint(
        dgrid_xyz[:, h:h + n, ise], dgrid_xyz[:, h + 1:h + n + 1, ise]
    )
    dyc[:, h:h + n, ise] = 2.0 * geometry.great_circle_distance_xyz(
        nmid, agrid_xyz[:, h:h + n, ise - 1], RADIUS
    )
    dxc, dyc = _halo_pair_np(topo, dxc, dyc, "x_iface", "y_iface")
    dxc, dyc = np.abs(dxc), np.abs(dyc)
    dxc, dyc = _fill_corners_vector_np(dxc, dyc, n, h, "C", vector=False)

    # ---- 6. area / area_c ------------------------------------------------
    area = np.full((6, N, N), -BIG_NUMBER)
    area[:, isc:iec + 1, isc:iec + 1] = geometry.cell_area_from_corners(
        dgrid_xyz[:, h:h + n + 1, h:h + n + 1], RADIUS
    )
    area = halo_c(area)

    area_c = np.zeros((6, N, N))
    area_c[:, h:h + n + 1, h:h + n + 1] = geometry.cell_area_from_corners(
        agrid_xyz[:, h - 1:h + n + 1, h - 1:h + n + 1], RADIUS
    )
    # corner fix: triangle area at the four cube corners
    ag = agrid_xyz
    for (ci, cj, tri) in (
        (h, h, (ag[:, h - 1, h], ag[:, h, h], ag[:, h, h - 1])),
        (ise, h, (ag[:, ise, h], ag[:, ise - 1, h], ag[:, ise - 1, h - 1])),
        (ise, ise, (ag[:, ise, ise - 1], ag[:, ise - 1, ise - 1], ag[:, ise - 1, ise])),
        (h, ise, (ag[:, h - 1, ise - 1], ag[:, h, ise - 1], ag[:, h, ise])),
    ):
        area_c[:, ci, cj] = geometry.get_triangle_area(*tri, RADIUS)
    # tile-border fix: the naive C-grid cell makes a butterfly shape across
    # the tile edge; use 2x the one-sided area instead (reference
    # gnomonic.py:419-545, applied in order west, north, east, south; the
    # 3x cube-corner variant is disabled in the reference, so corners end up
    # with the 2x edge rule of whichever edge wrote last)
    dgz, agz = dgrid_xyz, agrid_xyz
    ji = slice(h, h + n + 1)          # target interfaces along the edge
    c_lo = slice(h - 1, h + n)        # bracketing centers, lower
    c_hi = slice(h, h + n + 1)        # bracketing centers, upper
    # west
    wy = 0.5 * (dgz[:, isc, h - 1:h + n + 1] + dgz[:, isc, h:h + n + 2])
    area_c[:, isc, ji] = 2.0 * geometry.get_rectangle_area(
        wy[:, :-1], agz[:, isc, c_lo], agz[:, isc, c_hi], wy[:, 1:], RADIUS,
    )
    # north
    nx_ = 0.5 * (dgz[:, h - 1:h + n + 1, ise] + dgz[:, h:h + n + 2, ise])
    area_c[:, ji, ise] = 2.0 * geometry.get_rectangle_area(
        nx_[:, :-1], agz[:, c_lo, ise - 1], agz[:, c_hi, ise - 1],
        nx_[:, 1:], RADIUS,
    )
    # east
    ey = 0.5 * (dgz[:, ise, h - 1:h + n + 1] + dgz[:, ise, h:h + n + 2])
    area_c[:, ise, ji] = 2.0 * geometry.get_rectangle_area(
        ey[:, :-1], agz[:, ise - 1, c_lo], agz[:, ise - 1, c_hi],
        ey[:, 1:], RADIUS,
    )
    # south
    sx = 0.5 * (dgz[:, h - 1:h + n + 1, isc] + dgz[:, h:h + n + 2, isc])
    area_c[:, ji, isc] = 2.0 * geometry.get_rectangle_area(
        sx[:, :-1], agz[:, c_lo, isc], agz[:, c_hi, isc], sx[:, 1:], RADIUS,
    )
    area_c = halo_b(area_c)
    area_c = _fill_corners_2d_np(area_c, n, h, "B", "x")

    # ---- 7. unit vectors at centers / edges ------------------------------
    cm = slice(0, M - 1)   # cell slots
    ec1 = np.full((6, N, N, 3), BIG_NUMBER)
    ec2 = np.full((6, N, N, 3), BIG_NUMBER)
    cc = center_xyz  # (6, M-1, M-1, 3) normalized cell centers
    p1 = gnomonic.xyz_midpoint(dgrid_xyz[:, :M - 1, :M - 1], dgrid_xyz[:, :M - 1, 1:M])
    p2 = gnomonic.xyz_midpoint(dgrid_xyz[:, 1:M, :M - 1], dgrid_xyz[:, 1:M, 1:M])
    p3 = np.cross(p2, p1)
    ec1[:, cm, cm] = geometry.normalize_xyz(np.cross(cc, p3))
    p1 = gnomonic.xyz_midpoint(dgrid_xyz[:, :M - 1, :M - 1], dgrid_xyz[:, 1:M, :M - 1])
    p2 = gnomonic.xyz_midpoint(dgrid_xyz[:, :M - 1, 1:M], dgrid_xyz[:, 1:M, 1:M])
    p3 = np.cross(p2, p1)
    ec2[:, cm, cm] = geometry.normalize_xyz(np.cross(cc, p3))
    for arr in (ec1, ec2):
        _fill_wedges(arr, n, h, BIG_NUMBER)

    # ew1/ew2 at x-interfaces (i in 1..M-2), cells j
    ew1 = np.zeros((6, N, N, 3))
    ew2 = np.zeros((6, N, N, 3))
    pp = gnomonic.xyz_midpoint(
        dgrid_xyz[:, 1:M - 1, :M - 1], dgrid_xyz[:, 1:M - 1, 1:M]
    )
    p2 = np.cross(agrid_xyz[:, 0:M - 2, :M - 1], agrid_xyz[:, 1:M - 1, :M - 1])
    # tile-edge overrides (west edge at interface isc, east at ise)
    p2[:, isc - 1] = np.cross(pp[:, isc - 1], agrid_xyz[:, isc, :M - 1])
    p2[:, ise - 1] = np.cross(agrid_xyz[:, ise - 1, :M - 1], pp[:, ise - 1])
    ew1[:, 1:M - 1, cm] = geometry.normalize_xyz(np.cross(p2, pp))
    p1 = np.cross(dgrid_xyz[:, 1:M - 1, :M - 1], dgrid_xyz[:, 1:M - 1, 1:M])
    ew2[:, 1:M - 1, cm] = geometry.normalize_xyz(np.cross(p1, pp))
    for arr in (ew1, ew2):
        _fill_wedges(arr, n, h, 0.0)

    # es1/es2 at y-interfaces (j in 1..M-2), cells i
    es1 = np.zeros((6, N, N, 3))
    es2 = np.zeros((6, N, N, 3))
    pp = gnomonic.xyz_midpoint(
        dgrid_xyz[:, :M - 1, 1:M - 1], dgrid_xyz[:, 1:M, 1:M - 1]
    )
    p2 = np.cross(agrid_xyz[:, :M - 1, 0:M - 2], agrid_xyz[:, :M - 1, 1:M - 1])
    p2[:, :, isc - 1] = np.cross(pp[:, :, isc - 1], agrid_xyz[:, :M - 1, isc])
    p2[:, :, ise - 1] = np.cross(agrid_xyz[:, :M - 1, ise - 1], pp[:, :, ise - 1])
    es2[:, cm, 1:M - 1] = geometry.normalize_xyz(np.cross(p2, pp))
    p1 = np.cross(dgrid_xyz[:, :M - 1, 1:M - 1], dgrid_xyz[:, 1:M, 1:M - 1])
    es1[:, cm, 1:M - 1] = geometry.normalize_xyz(np.cross(p1, pp))
    for arr in (es1, es2):
        _fill_wedges(arr, n, h, 0.0)

    # ---- 8. supergrid trig ------------------------------------------------
    cos_sg = np.full((6, N, N, 9), BIG_NUMBER)
    dg = dgrid_xyz
    # sg6..sg9: angles at the four cell corners (ll, lr, ur, ul)
    cos_sg[:, cm, cm, 5] = geometry.spherical_cos(
        dg[:, :M - 1, :M - 1], dg[:, 1:M, :M - 1], dg[:, :M - 1, 1:M]
    )
    cos_sg[:, cm, cm, 6] = -geometry.spherical_cos(
        dg[:, 1:M, :M - 1], dg[:, :M - 1, :M - 1], dg[:, 1:M, 1:M]
    )
    cos_sg[:, cm, cm, 7] = geometry.spherical_cos(
        dg[:, 1:M, 1:M], dg[:, 1:M, :M - 1], dg[:, :M - 1, 1:M]
    )
    cos_sg[:, cm, cm, 8] = -geometry.spherical_cos(
        dg[:, :M - 1, 1:M], dg[:, :M - 1, :M - 1], dg[:, 1:M, 1:M]
    )
    mid = gnomonic.xyz_midpoint(dg[:, :M - 1, :M - 1], dg[:, :M - 1, 1:M])
    cos_sg[:, cm, cm, 0] = geometry.spherical_cos(
        mid, agrid_xyz[:, :M - 1, :M - 1], dg[:, :M - 1, 1:M]
    )
    mid = gnomonic.xyz_midpoint(dg[:, :M - 1, :M - 1], dg[:, 1:M, :M - 1])
    cos_sg[:, cm, cm, 1] = geometry.spherical_cos(
        mid, dg[:, 1:M, :M - 1], agrid_xyz[:, :M - 1, :M - 1]
    )
    mid = gnomonic.xyz_midpoint(dg[:, 1:M, :M - 1], dg[:, 1:M, 1:M])
    cos_sg[:, cm, cm, 2] = geometry.spherical_cos(
        mid, agrid_xyz[:, :M - 1, :M - 1], dg[:, 1:M, :M - 1]
    )
    mid = gnomonic.xyz_midpoint(dg[:, :M - 1, 1:M], dg[:, 1:M, 1:M])
    cos_sg[:, cm, cm, 3] = geometry.spherical_cos(
        mid, dg[:, :M - 1, 1:M], agrid_xyz[:, :M - 1, :M - 1]
    )
    cos_sg[:, cm, cm, 4] = (ec1[:, cm, cm] * ec2[:, cm, cm]).sum(-1)
    cos_sg[np.abs(1.0 - cos_sg) < 1e-15] = 1.0
    sin_sg = np.sqrt(np.clip(1.0 - cos_sg ** 2, 0.0, None))
    sin_sg = np.minimum(sin_sg, 1.0)

    _supergrid_corner_adjust(sin_sg, n, h)

    # ---- 9. derived trig (cosa, sina, ...) --------------------------------
    trig = _calculate_trig_uv(cos_sg, sin_sg, n, h, N, M)

    # corner wedge fixes applied after cosa etc. (reference order)
    _supergrid_corner_fix(cos_sg, sin_sg, n, h)

    # ---- 10. l2c, ee vectors ----------------------------------------------
    # l2c (AAM lat-lon correction), compute domain only
    l2c_u = np.zeros((6, N, N))
    l2c_v = np.zeros((6, N, N))
    glonlat = np.stack([lon, lat], axis=-1)
    p1v = glonlat[:, h:h + n + 1, h:h + n]
    p2v = glonlat[:, h:h + n + 1, h + 1:h + n + 1]
    midlon, midlat = geometry.lon_lat_midpoint(
        p1v[..., 0], p2v[..., 0], p1v[..., 1], p2v[..., 1]
    )
    unit_dir = geometry.get_unit_vector_direction(p1v, p2v)
    ex, _ = geometry.lonlat_unit_vectors(midlon, midlat)
    l2c_v[:, h:h + n + 1, h:h + n] = np.cos(midlat) * (unit_dir * ex).sum(-1)
    p1u = glonlat[:, h:h + n, h:h + n + 1]
    p2u = glonlat[:, h + 1:h + n + 1, h:h + n + 1]
    midlon, midlat = geometry.lon_lat_midpoint(
        p1u[..., 0], p2u[..., 0], p1u[..., 1], p2u[..., 1]
    )
    unit_dir = geometry.get_unit_vector_direction(p1u, p2u)
    ex, _ = geometry.lonlat_unit_vectors(midlon, midlat)
    l2c_u[:, h:h + n, h:h + n + 1] = np.cos(midlat) * (unit_dir * ex).sum(-1)

    # ee1/ee2 at corners [h:h+n+1]
    ee1 = np.full((6, N, N, 3), np.nan)
    ee2 = np.full((6, N, N, 3), np.nan)
    Jc = slice(h, h + n + 1)
    cvx = np.cross(dg[:, h - 1:h + n, Jc], dg[:, h + 1:h + n + 2, Jc])
    cvx[:, 0] = np.cross(dg[:, h, Jc], dg[:, h + 1, Jc])
    cvx[:, -1] = np.cross(dg[:, h + n - 1, Jc], dg[:, h + n, Jc])
    ee1[:, Jc, Jc] = geometry.normalize_xyz(np.cross(cvx, dg[:, Jc, Jc]))
    cvy = np.cross(dg[:, Jc, h - 1:h + n], dg[:, Jc, h + 1:h + n + 2])
    cvy[:, :, 0] = np.cross(dg[:, Jc, h], dg[:, Jc, h + 1])
    cvy[:, :, -1] = np.cross(dg[:, Jc, h + n - 1], dg[:, Jc, h + n])
    ee2[:, Jc, Jc] = geometry.normalize_xyz(np.cross(cvy, dg[:, Jc, Jc]))

    # ---- 11. divergence-damping coefficients ------------------------------
    sina_u, sina_v = trig["sina_u"], trig["sina_v"]
    err = np.errstate(divide="ignore", invalid="ignore")
    err.__enter__()
    divg_u = sina_v * dyc / dx
    del6_u = sina_v * dx / dyc
    divg_v = sina_u * dxc / dy
    del6_v = sina_u * dy / dxc
    # tile-edge overrides using one-sided sin_sg averages
    s_south = 0.5 * (sin_sg[:, :, h, 1] + sin_sg[:, :, h - 1, 3])
    divg_u[:, :, h] = s_south * dyc[:, :, h] / dx[:, :, h]
    del6_u[:, :, h] = s_south * dx[:, :, h] / dyc[:, :, h]
    s_north = 0.5 * (sin_sg[:, :, h + n, 1] + sin_sg[:, :, h + n - 1, 3])
    divg_u[:, :, ise] = s_north * dyc[:, :, ise] / dx[:, :, ise]
    del6_u[:, :, ise] = s_north * dx[:, :, ise] / dyc[:, :, ise]
    s_west = 0.5 * (sin_sg[:, h, :, 0] + sin_sg[:, h - 1, :, 2])
    divg_v[:, h, :] = s_west * dxc[:, h, :] / dy[:, h, :]
    del6_v[:, h, :] = s_west * dy[:, h, :] / dxc[:, h, :]
    s_east = 0.5 * (sin_sg[:, h + n, :, 0] + sin_sg[:, h + n - 1, :, 2])
    divg_v[:, ise, :] = s_east * dxc[:, ise, :] / dy[:, ise, :]
    del6_v[:, ise, :] = s_east * dy[:, ise, :] / dxc[:, ise, :]
    err.__exit__(None, None, None)
    divg_v, divg_u = _halo_pair_np(topo, divg_v, divg_u, "x_iface", "y_iface")
    del6_v, del6_u = _halo_pair_np(topo, del6_v, del6_u, "x_iface", "y_iface")
    divg_v, divg_u = np.abs(divg_v), np.abs(divg_u)
    del6_v, del6_u = np.abs(del6_v), np.abs(del6_u)

    # ---- 12. lat-lon transform matrices ------------------------------------
    # full-array (defined wherever agrid is; the A->D physics wind update
    # reads them one ring into the halo, reference update_dwind_phys.py:20-45)
    with np.errstate(invalid="ignore"):
        vlon, vlat = geometry.lonlat_unit_vectors(lon_agrid, lat_agrid)
    z11 = (ec1 * vlon).sum(-1)
    z12 = (ec1 * vlat).sum(-1)
    z21 = (ec2 * vlon).sum(-1)
    z22 = (ec2 * vlat).sum(-1)
    sin5 = sin_sg[..., 4]
    with np.errstate(divide="ignore", invalid="ignore"):
        a11 = 0.5 * z22 / sin5
        a12 = -0.5 * z12 / sin5
        a21 = -0.5 * z21 / sin5
        a22 = 0.5 * z11 / sin5

    # ---- 13. edge interpolation factors ------------------------------------
    edge_w, edge_e, edge_s, edge_n = _edge_factors(
        lon, lat, lon_agrid, lat_agrid, n, h, N
    )
    edge_vect_w, edge_vect_e, edge_vect_s, edge_vect_n = _edge_vect_factors(
        lon, lat, lon_agrid, lat_agrid, n, h, N
    )

    # ---- 14. Coriolis, area reductions -------------------------------------
    fC = 2.0 * OMEGA * np.sin(lat)
    f0 = 2.0 * OMEGA * np.sin(lat_agrid)

    comp_area = area[:, isc:iec + 1, isc:iec + 1]
    comp_area_c = area_c[:, isc:iec + 1, isc:iec + 1]
    da_min = float(comp_area.min())
    da_max = float(comp_area.max())
    da_min_c = float(comp_area_c.min())
    da_max_c = float(comp_area_c.max())

    def safe_inv(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            out = 1.0 / x
        return np.where(np.isfinite(out), out, 0.0)

    horizontal = dict(
        lon=lon, lat=lat, lon_agrid=lon_agrid, lat_agrid=lat_agrid,
        area=area, rarea=safe_inv(area), area_c=area_c,
        rarea_c=safe_inv(area_c),
        dx=dx, dy=dy, dxc=dxc, dyc=dyc, dxa=dxa, dya=dya,
        rdx=safe_inv(dx), rdy=safe_inv(dy), rdxc=safe_inv(dxc),
        rdyc=safe_inv(dyc), rdxa=safe_inv(dxa), rdya=safe_inv(dya),
        a11=a11, a12=a12, a21=a21, a22=a22,
        edge_w=edge_w, edge_e=edge_e, edge_s=edge_s, edge_n=edge_n,
        edge_vect_w=edge_vect_w, edge_vect_e=edge_vect_e,
        edge_vect_s=edge_vect_s, edge_vect_n=edge_vect_n,
        ec1=ec1, ec2=ec2, ew1=ew1, ew2=ew2, es1=es1, es2=es2,
        ee1=ee1, ee2=ee2, vlon=vlon, vlat=vlat,
        z11=z11, z12=z12, z21=z21, z22=z22, l2c_u=l2c_u, l2c_v=l2c_v,
        fC=fC, f0=f0,
    )
    angle = dict(cos_sg=cos_sg, sin_sg=sin_sg, **trig)
    damping = dict(
        divg_u=divg_u, divg_v=divg_v, del6_u=del6_u, del6_v=del6_v,
        da_min=da_min, da_max=da_max, da_min_c=da_min_c, da_max_c=da_max_c,
    )
    return dict(horizontal=horizontal, angle=angle, damping=damping)


def _fill_wedges(arr, n, h, value):
    """Set corner-wedge halo regions to a fill value (first two axes after
    tile are i, j)."""
    lo = slice(0, h)
    hi = slice(h + n, None)
    arr[:, lo, lo] = value
    arr[:, lo, hi] = value
    arr[:, hi, lo] = value
    arr[:, hi, hi] = value


def _calculate_trig_uv(cos_sg, sin_sg, n, h, N, M):
    """cosa/sina at corners, u/v/center points (reference geometry.py:313)."""
    isc, ise = h, h + n
    cosa = np.full((6, N, N), BIG_NUMBER)
    sina = np.full((6, N, N), BIG_NUMBER)
    Jc = slice(h, h + n + 1)
    cosa[:, Jc, Jc] = 0.5 * (
        cos_sg[:, h - 1:h + n, h - 1:h + n, 7]
        + cos_sg[:, h:h + n + 1, h:h + n + 1, 5]
    )
    sina[:, Jc, Jc] = 0.5 * (
        sin_sg[:, h - 1:h + n, h - 1:h + n, 7]
        + sin_sg[:, h:h + n + 1, h:h + n + 1, 5]
    )
    cosa_u = np.full((6, N, N), BIG_NUMBER)
    sina_u = np.full((6, N, N), BIG_NUMBER)
    rsin_u = np.full((6, N, N), BIG_NUMBER)
    cosa_u[:, 1:M - 1] = 0.5 * (cos_sg[:, :M - 2, :, 2] + cos_sg[:, 1:M - 1, :, 0])
    sina_u[:, 1:M - 1] = 0.5 * (sin_sg[:, :M - 2, :, 2] + sin_sg[:, 1:M - 1, :, 0])
    rsin_u[:, 1:M - 1] = 1.0 / np.maximum(sina_u[:, 1:M - 1] ** 2, TINY_NUMBER)
    cosa_v = np.full((6, N, N), BIG_NUMBER)
    sina_v = np.full((6, N, N), BIG_NUMBER)
    rsin_v = np.full((6, N, N), BIG_NUMBER)
    cosa_v[:, :, 1:M - 1] = 0.5 * (
        cos_sg[:, :, :M - 2, 3] + cos_sg[:, :, 1:M - 1, 1]
    )
    sina_v[:, :, 1:M - 1] = 0.5 * (
        sin_sg[:, :, :M - 2, 3] + sin_sg[:, :, 1:M - 1, 1]
    )
    rsin_v[:, :, 1:M - 1] = 1.0 / np.maximum(sina_v[:, :, 1:M - 1] ** 2, TINY_NUMBER)

    cosa_s = cos_sg[..., 4].copy()
    rsin2 = 1.0 / np.maximum(sin_sg[..., 4] ** 2, TINY_NUMBER)
    _fill_wedges(cosa_s[..., None], n, h, BIG_NUMBER)

    rsina = np.full((6, N, N), BIG_NUMBER)
    rsina[:, Jc, Jc] = 1.0 / np.maximum(sina[:, Jc, Jc] ** 2, TINY_NUMBER)

    # tile-edge special values
    rsina[:, isc, Jc] = BIG_NUMBER
    rsina[:, ise, Jc] = BIG_NUMBER
    rsina[:, Jc, isc] = BIG_NUMBER
    rsina[:, Jc, ise] = BIG_NUMBER

    def limited_inverse(row):
        lim = np.where(
            np.abs(row) < TINY_NUMBER, TINY_NUMBER * np.sign(row), row
        )
        lim = np.where(lim == 0.0, TINY_NUMBER, lim)
        return 1.0 / lim

    rsin_u[:, isc] = limited_inverse(sina_u[:, isc])
    rsin_u[:, ise] = limited_inverse(sina_u[:, ise])
    rsin_v[:, :, isc] = limited_inverse(sina_v[:, :, isc])
    rsin_v[:, :, ise] = limited_inverse(sina_v[:, :, ise])

    return dict(
        cosa=cosa, sina=sina, cosa_u=cosa_u, cosa_v=cosa_v, cosa_s=cosa_s,
        sina_u=sina_u, sina_v=sina_v, rsina=rsina, rsin_u=rsin_u,
        rsin_v=rsin_v, rsin2=rsin2,
    )


def _supergrid_corner_adjust(sin_sg, n, h):
    """Tile-corner sin_sg continuation (reference geometry.py:219-230)."""
    mc_last = h + n  # index of the first east/north halo cell
    # sw corner
    sin_sg[:, h - 1, 0:h, 2] = sin_sg[:, 0:h, h, 1]
    sin_sg[:, 0:h, h - 1, 3] = sin_sg[:, h, 0:h, 0]
    # nw corner
    sin_sg[:, h - 1, mc_last:mc_last + h, 2] = \
        sin_sg[:, 0:h, mc_last - 1, 3][:, ::-1]
    sin_sg[:, 0:h, mc_last, 1] = sin_sg[:, h, mc_last - 2:mc_last + 1, 0]
    # se corner
    sin_sg[:, mc_last, 0:h, 0] = sin_sg[:, mc_last:mc_last + h, h, 1][:, ::-1]
    sin_sg[:, mc_last:mc_last + h, h - 1, 3] = \
        sin_sg[:, mc_last - 1, 0:h, 2][:, ::-1]
    # ne corner
    sin_sg[:, mc_last, mc_last:mc_last + h, 0] = \
        sin_sg[:, mc_last:mc_last + h, mc_last - 1, 3]
    sin_sg[:, mc_last:mc_last + h, mc_last, 1] = \
        sin_sg[:, mc_last - 1, mc_last:mc_last + h, 2]


def _supergrid_corner_fix(cos_sg, sin_sg, n, h):
    """Wedge fill + rotations for supergrid trig at the four cube corners
    (reference geometry.py:421-476)."""
    lo = slice(0, h)
    hi = slice(h + n, h + n + h)
    for arr, fill in ((sin_sg, TINY_NUMBER), (cos_sg, BIG_NUMBER)):
        arr[:, lo, lo] = fill
        arr[:, lo, hi] = fill
        arr[:, hi, lo] = fill
        arr[:, hi, hi] = fill

    # explicit index forms of the reference's flip-composed rotations
    # (mirrors evaluated on the ACTIVE cell region [0, n+2h), not the
    # padded array)
    e = h + n  # first east/north wedge cell index (= mc - h)
    for sg in (sin_sg, cos_sg):
        # sw: ccw(sg2 -> sg3), cw(sg1 -> sg4)
        sg[:, h - 1, 0:h, 2] = sg[:, 0:h, h, 1]
        sg[:, 0:h, h - 1, 3] = sg[:, h, 0:h, 0]
        # nw: ccw(sg1 -> sg2), cw(sg4 -> sg3)
        sg[:, 0:h, e, 1] = sg[:, h, e:e + h, 0][:, ::-1]
        sg[:, h - 1, e:e + h, 2] = sg[:, 0:h, e - 1, 3][:, ::-1]
        # se: cw(sg2 -> sg1), ccw(sg3 -> sg4)
        sg[:, e, 0:h, 0] = sg[:, e:e + h, h, 1][:, ::-1]
        sg[:, e:e + h, h - 1, 3] = sg[:, e - 1, 0:h, 2][:, ::-1]
        # ne: ccw(sg4 -> sg1), cw(sg3 -> sg2)
        sg[:, e, e:e + h, 0] = sg[:, e:e + h, e - 1, 3]
        sg[:, e:e + h, e, 1] = sg[:, e - 1, e:e + h, 2]


def _edge_factors(lon, lat, lon_a, lat_a, n, h, N):
    """A->B interpolation factors on tile edges (reference
    geometry.py:590-700).  Computed for interface indices [h+1, h+n) along
    each edge; BIG_NUMBER elsewhere."""
    edge_w = np.full((6, N), BIG_NUMBER)
    edge_e = np.full((6, N), BIG_NUMBER)
    edge_s = np.full((6, N), BIG_NUMBER)
    edge_n = np.full((6, N), BIG_NUMBER)
    js = slice(h + 1, h + n)   # target interface points (edge interior, n-1)
    cs = slice(h, h + n)       # cell centers along the edge (n points)

    def factor(edge_lon, edge_lat, in_lon0, in_lat0, in_lon1, in_lat1):
        """in0/in1: A-grid centers on either side of the edge line (n points
        along the edge); edge: interior B-grid edge points (n-1)."""
        mid_lon, mid_lat = geometry.lon_lat_midpoint(
            in_lon0, in_lon1, in_lat0, in_lat1
        )
        d1 = geometry.great_circle_distance_lon_lat(
            mid_lon[:, :-1], edge_lon, mid_lat[:, :-1], edge_lat, RADIUS
        )
        d2 = geometry.great_circle_distance_lon_lat(
            mid_lon[:, 1:], edge_lon, mid_lat[:, 1:], edge_lat, RADIUS
        )
        return d2 / (d1 + d2)

    # west edge: centers at i = h-1 (halo) and i = h (interior)
    edge_w[:, js] = factor(
        lon[:, h, js], lat[:, h, js],
        lon_a[:, h - 1, cs], lat_a[:, h - 1, cs],
        lon_a[:, h, cs], lat_a[:, h, cs],
    )
    edge_e[:, js] = factor(
        lon[:, h + n, js], lat[:, h + n, js],
        lon_a[:, h + n, cs], lat_a[:, h + n, cs],
        lon_a[:, h + n - 1, cs], lat_a[:, h + n - 1, cs],
    )
    edge_s[:, js] = factor(
        lon[:, js, h], lat[:, js, h],
        lon_a[:, cs, h - 1], lat_a[:, cs, h - 1],
        lon_a[:, cs, h], lat_a[:, cs, h],
    )
    edge_n[:, js] = factor(
        lon[:, js, h + n], lat[:, js, h + n],
        lon_a[:, cs, h + n], lat_a[:, cs, h + n],
        lon_a[:, cs, h + n - 1], lat_a[:, cs, h + n - 1],
    )
    return edge_w, edge_e, edge_s, edge_n


def _edge_vect_factors(lon, lat, lon_a, lat_a, n, h, N):
    """A->C vector interpolation factors on tile edges (reference
    geometry.py:703-860 efactor_a2c_v).  1D per-edge arrays over cell
    indices [h-1, h+n+1); BIG_NUMBER elsewhere."""
    edge_vect_w = np.full((6, N), BIG_NUMBER)
    edge_vect_e = np.full((6, N), BIG_NUMBER)
    edge_vect_s = np.full((6, N), BIG_NUMBER)
    edge_vect_n = np.full((6, N), BIG_NUMBER)
    im2 = n // 2  # cells with index < mid use the "lower" bracketing pair

    def west_factors(glon, glat, alon, alat):
        """Generic west-edge computation; other edges by symmetry transforms.
        glon/glat: corner arrays (6, N, N); alon/alat: center arrays."""
        # py: midpoints between first-halo and first-interior center columns,
        # for cells [h-2, h+n+2)
        cs = slice(h - 2, h + n + 2)
        py_lon, py_lat = geometry.lon_lat_midpoint(
            alon[:, h - 1, cs], alon[:, h, cs], alat[:, h - 1, cs],
            alat[:, h, cs],
        )
        # p2: midpoints of D-grid edge segments (C-grid u points on the edge)
        # for cells [h-2, h+n+2), same coverage as py
        p2_lon, p2_lat = geometry.lon_lat_midpoint(
            glon[:, h, h - 2:h + n + 2], glon[:, h, h - 1:h + n + 3],
            glat[:, h, h - 2:h + n + 2], glat[:, h, h - 1:h + n + 3],
        )
        # target cells: storage [h-1, h+n+1), i.e. local cells -1..n
        ncells = n + 2
        d1 = np.empty((6, ncells))
        d2 = np.empty((6, ncells))
        # lower half (local cell index < im2): bracket with (py[k], py[k+1])
        lo = slice(0, im2 + 1)      # local target cells -1..im2-1
        d1[:, lo] = geometry.great_circle_distance_lon_lat(
            py_lon[:, 1:im2 + 2], p2_lon[:, 1:im2 + 2],
            py_lat[:, 1:im2 + 2], p2_lat[:, 1:im2 + 2], RADIUS,
        )
        d2[:, lo] = geometry.great_circle_distance_lon_lat(
            py_lon[:, 2:im2 + 3], p2_lon[:, 1:im2 + 2],
            py_lat[:, 2:im2 + 3], p2_lat[:, 1:im2 + 2], RADIUS,
        )
        hi = slice(im2 + 1, ncells)
        d1[:, hi] = geometry.great_circle_distance_lon_lat(
            py_lon[:, im2 + 2:-1], p2_lon[:, im2 + 2:-1],
            py_lat[:, im2 + 2:-1], p2_lat[:, im2 + 2:-1], RADIUS,
        )
        d2[:, hi] = geometry.great_circle_distance_lon_lat(
            py_lon[:, im2 + 1:-2], p2_lon[:, im2 + 2:-1],
            py_lat[:, im2 + 1:-2], p2_lat[:, im2 + 2:-1], RADIUS,
        )
        return d1 / (d2 + d1)

    tgt = slice(h - 1, h + n + 1)

    def transpose(a):
        return a.transpose(0, 2, 1)

    def flip_active_corners(a):
        # corners occupy [0, n+2h+1) of axis 1; flip that region
        M = n + 2 * h + 1
        out = a.copy()
        out[:, :M] = a[:, M - 1::-1]
        return out

    def flip_active_cells(a):
        mc = n + 2 * h
        out = a.copy()
        out[:, :mc] = a[:, mc - 1::-1]
        return out

    edge_vect_w[:, tgt] = west_factors(lon, lat, lon_a, lat_a)
    # east edge: mirror in i; the along-edge (j) parameterization is
    # unchanged so no result flip (reference calculate_east_edge_vectors)
    edge_vect_e[:, tgt] = west_factors(
        flip_active_corners(lon), flip_active_corners(lat),
        flip_active_cells(lon_a), flip_active_cells(lat_a),
    )
    edge_vect_s[:, tgt] = west_factors(
        transpose(lon), transpose(lat), transpose(lon_a), transpose(lat_a)
    )
    # north edge: mirror in j then transpose (mirror in i after transpose)
    edge_vect_n[:, tgt] = west_factors(
        flip_active_corners(transpose(lon)),
        flip_active_corners(transpose(lat)),
        flip_active_cells(transpose(lon_a)),
        flip_active_cells(transpose(lat_a)),
    )
    # edge continuation at tile corners (reference efactor_a2c_v corners)
    for arr in (edge_vect_w, edge_vect_e):
        arr[:, h - 1] = arr[:, h]
        arr[:, h + n] = arr[:, h + n - 1]
    for arr in (edge_vect_s, edge_vect_n):
        arr[:, h - 1] = arr[:, h]
        arr[:, h + n] = arr[:, h + n - 1]
    return edge_vect_w, edge_vect_e, edge_vect_s, edge_vect_n
