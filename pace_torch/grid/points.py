"""The metric terms at given storage points: a rank's block of the grid.

`generation._metric_terms` derives every metric term of the whole cube at
once, on (6, N, N) arrays, filling halos with the topology's gather maps
and cube-corner wedges with the corner-fill tables.  `PointMetrics`
derives the same raw float64 terms at any list of storage points
(tile, i, j) of one grid: each term at a point is the same elementwise
arithmetic on the same inputs, gathered from the points its stencil reads,
so a point's value does not depend on which other points are evaluated
with it, and equals the whole cube's bit for bit.  A halo point takes its
value at the source the topology's gather reads
(`CubedSphereTopology.scalar_source_at` / `vector_source_at`), a wedge
point at the source of its corner fill; the corners themselves are the
gnomonic tile's (`gnomonic.corner_xyz_at`).  Evaluated terms are kept per
point, so each is computed once whatever reads it.

A rank evaluates its block (`RankPart`) and the points its halo and the
initial state read; nothing of the size of the cube is held but the
gnomonic tile's corners and, where the four area extremes are computed
(`area_extremes`), one chunk of one tile's compute cells at a time.
"""

from __future__ import annotations

import functools

import numpy as np

from pace_torch.grid import geometry, gnomonic
from pace_torch.grid.generation import BIG_NUMBER, TINY_NUMBER
from pace_torch.ops import corners as corner_ops
from pace_torch.parallel.topology import get_topology
from pace_torch.utils.constants import N_HALO_DEFAULT, OMEGA, PI, RADIUS
from pace_torch.utils.gridtools import Domain, GridSizing

def _safe_inv(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        out = 1.0 / x
    return np.where(np.isfinite(out), out, 0.0)


def _limited_inverse(row):
    lim = np.where(np.abs(row) < TINY_NUMBER, TINY_NUMBER * np.sign(row),
                   row)
    lim = np.where(lim == 0.0, TINY_NUMBER, lim)
    return 1.0 / lim


def _rect(p1, p2, p3, p4):
    return geometry.get_rectangle_area(p1, p2, p3, p4, RADIUS)


def _gcd_xyz(p1, p2):
    return geometry.great_circle_distance_xyz(p1, p2, RADIUS)


def _gcd(lon1, lon2, lat1, lat2):
    return geometry.great_circle_distance_lon_lat(lon1, lon2, lat1, lat2,
                                                  RADIUS)


def _rotation_tables(n: int, h: int):
    """The supergrid corner continuations of `_supergrid_corner_adjust`
    (sin_sg only) and `_supergrid_corner_fix`, as (target i, j, component)
    <- (source i, j, component) rows.  Within each, no row's source is
    another's target, so the statements' order does not matter."""
    e = h + n
    adjust, fix = [], []
    for k in range(h):
        adjust += [
            ((h - 1, k, 2), (k, h, 1)),
            ((k, h - 1, 3), (h, k, 0)),
            ((h - 1, e + k, 2), (h - 1 - k, e - 1, 3)),
            ((k, e, 1), (h, e - 2 + k, 0)),
            ((e, k, 0), (e + h - 1 - k, h, 1)),
            ((e + k, h - 1, 3), (e - 1, h - 1 - k, 2)),
            ((e, e + k, 0), (e + k, e - 1, 3)),
            ((e + k, e, 1), (e - 1, e + k, 2)),
        ]
        fix += [
            ((h - 1, k, 2), (k, h, 1)),
            ((k, h - 1, 3), (h, k, 0)),
            ((k, e, 1), (h, e + h - 1 - k, 0)),
            ((h - 1, e + k, 2), (h - 1 - k, e - 1, 3)),
            ((e, k, 0), (e + h - 1 - k, h, 1)),
            ((e + k, h - 1, 3), (e - 1, h - 1 - k, 2)),
            ((e, e + k, 0), (e + k, e - 1, 3)),
            ((e + k, e, 1), (e - 1, e + k, 2)),
        ]
    return adjust, fix


def _by_target(rows) -> dict:
    """{(i, j): [(component, source i, source j, source component)]}."""
    out = {}
    for (ti, tj, tc), (si, sj, sc) in rows:
        out.setdefault((ti, tj), []).append((tc, si, sj, sc))
    return out


class PointMetrics:
    """The raw float64 metric terms of a C`n` grid (`_metric_terms`'
    values, NaN and BIG_NUMBER fills included) at storage points.

    `get(name, t, i, j)` returns term `name` at the points (t, i, j) (int
    arrays of one shape; a trailing axis for vector terms); `edge(name, t,
    k)` an edge table's entries."""

    def __init__(self, n: int, halo: int = N_HALO_DEFAULT,
                 stretch_factor: float = None, lon_target: float = 350.0,
                 lat_target: float = -90.0):
        if stretch_factor is None or stretch_factor == 1.0:
            stretch_factor, lon_target, lat_target = None, 350.0, -90.0
        self.n, self.h = n, halo
        self.N = GridSizing(n, 1, halo).N
        self.M = n + 2 * halo + 1
        self.stretch = (None if stretch_factor is None else dict(
            stretch_factor=stretch_factor, lon_target=float(lon_target),
            lat_target=float(lat_target)))
        self.topo = get_topology(n, halo)
        self._store = {}
        self._adjust, self._fix = (_by_target(rows) for rows in
                                   _rotation_tables(n, halo))

    # -- the store ------------------------------------------------------------
    def get(self, name: str, t, i, j) -> np.ndarray:
        t, i, j = (np.asarray(a, np.int64) for a in (t, i, j))
        if not t.shape == i.shape == j.shape:
            t, i, j = np.broadcast_arrays(t, i, j)
        shape = t.shape
        key = ((t * self.N + i) * self.N + j).ravel()
        keys, vals = self._store.get(name, (np.empty(0, np.int64), None))
        missing = key
        if keys.size:
            pos = np.minimum(np.searchsorted(keys, key), keys.size - 1)
            missing = key[keys[pos] != key]
        if missing.size or vals is None:
            new = np.unique(missing)
            nt, rest = np.divmod(new, self.N * self.N)
            ni, nj = np.divmod(rest, self.N)
            got = np.asarray(getattr(self, "_" + name)(nt, ni, nj),
                             np.float64)
            if vals is not None:
                new = np.concatenate([keys, new])
                got = np.concatenate([vals, got])
                order = np.argsort(new, kind="stable")
                new, got = new[order], got[order]
            keys, vals = new, got
            self._store[name] = (keys, vals)
        out = vals[np.searchsorted(keys, key)]
        return out.reshape(shape + vals.shape[1:])

    def _at(self, name, t, i, j, di=0, dj=0):
        return self.get(name, t, i + di, j + dj)

    def _fill(self, shape, value, t, i, j, where, fn):
        """`value` everywhere, `fn` of the points `where` selects."""
        out = np.full(np.shape(t) + shape, value, dtype=np.float64)
        if where.any():
            out[where] = fn(t[where], i[where], j[where])
        return out

    # -- index maps -----------------------------------------------------------
    def _corner_2d(self, gridtype, direction, t, i, j):
        SI, SJ = corner_ops._fill_corners_2d_perm(
            Domain.whole(self.n, self.h), gridtype, direction)
        return t, SI[i, j].astype(np.int64), SJ[i, j].astype(np.int64)

    def _pair(self, base, u_stagger, v_stagger, t, i, j):
        """The halo pair (unsigned) of `base` (a (P, 2) term of u and v)."""
        out = np.empty(np.shape(t) + (2,))
        for comp in (0, 1):
            st, si, sj, sc, _ = self.topo.vector_source_at(
                u_stagger, v_stagger, comp, t, i, j)
            src = self.get(base, st, si, sj)
            out[:, comp] = np.where(sc == 0, src[:, 0], src[:, 1])
        return out

    def _wedge(self, i, j, hi_end=None):
        h, n = self.h, self.n
        hi_end = self.N if hi_end is None else hi_end
        lo_i, lo_j = i < h, j < h
        hi_i = (i >= h + n) & (i < hi_end)
        hi_j = (j >= h + n) & (j < hi_end)
        return (lo_i | hi_i) & (lo_j | hi_j)

    # -- 1. D-grid corner lon/lat ---------------------------------------------
    def _grid_pre(self, t, i, j):
        """Corner (lon, lat) before the halo fill: the tile's (shifted,
        stretched, with |x| < 1e-10 zeroed) on its compute corners, else
        0."""
        h, n = self.h, self.n
        out = np.zeros(np.shape(t) + (2,))
        m = (i >= h) & (i <= h + n) & (j >= h) & (j <= h + n)
        if m.any():
            lon, lat = gnomonic.corner_lonlat_at(n, t[m], i[m] - h, j[m] - h)
            lon = lon - PI / 18.0
            lon = np.where(lon < 0, lon + 2 * PI, lon)
            if self.stretch is not None:
                from pace_torch.grid.stretch_transformation import (
                    direct_transform,
                )

                lon, lat = direct_transform(lon=lon, lat=lat,
                                            **self.stretch)
            vals = np.stack([lon, lat], axis=-1)
            vals[np.abs(vals) < 1e-10] = 0.0
            out[m] = vals
        return out

    def _grid(self, t, i, j):
        t, i, j = self._corner_2d("B", "x", t, i, j)
        return self.get("grid_pre", *self.topo.scalar_source_at(
            "corner", t, i, j))

    def _dg(self, t, i, j):
        g = self.get("grid", t, i, j)
        return geometry.lonlat_to_xyz(g[:, 0], g[:, 1])

    # -- 2. A-grid ------------------------------------------------------------
    def _center(self, t, i, j):
        """Raw cell-center xyz (cells below M - 1)."""
        return gnomonic.xyz_midpoint(
            self._at("dg", t, i, j), self._at("dg", t, i, j, 1),
            self._at("dg", t, i, j, 0, 1), self._at("dg", t, i, j, 1, 1))

    def _agrid_pre(self, t, i, j):
        def fn(t, i, j):
            lon, lat = geometry.xyz_to_lonlat(self.get("center", t, i, j))
            return np.stack([lon, lat], axis=-1)

        M = self.M
        return self._fill((2,), np.nan, t, i, j, (i < M - 1) & (j < M - 1),
                          fn)

    def _agrid(self, t, i, j):
        out = np.empty(np.shape(t) + (2,))
        for comp, direction in ((0, "x"), (1, "y")):
            src = self._corner_2d("A", direction, t, i, j)
            out[:, comp] = self.get("agrid_pre", *self.topo.scalar_source_at(
                "center", *src))[:, comp]
        return out

    def _ag(self, t, i, j):
        a = self.get("agrid", t, i, j)
        return geometry.lonlat_to_xyz(a[:, 0], a[:, 1])

    # -- 3. dx / dy -----------------------------------------------------------
    def _dxdy_pre(self, t, i, j):
        M = self.M
        out = np.zeros(np.shape(t) + (2,))

        def dist(t, i, j, di, dj):
            g0, g1 = self._at("grid", t, i, j), self._at("grid", t, i, j,
                                                          di, dj)
            return _gcd(g0[:, 0], g1[:, 0], g0[:, 1], g1[:, 1])

        m = (i < M - 1) & (j < M)
        out[m, 0] = dist(t[m], i[m], j[m], 1, 0)
        m = (i < M) & (j < M - 1)
        out[m, 1] = dist(t[m], i[m], j[m], 0, 1)
        return out

    def _dxdy_h(self, t, i, j):
        return np.abs(self._pair("dxdy_pre", "y_iface", "x_iface", t, i, j))

    def _dx(self, t, i, j):
        return self._corner_vector_of("dxdy_h", 0, "D", t, i, j)

    def _dy(self, t, i, j):
        return self._corner_vector_of("dxdy_h", 1, "D", t, i, j)

    def _corner_vector_of(self, base, tgt, grid, t, i, j):
        """Component `tgt` of the pair `base` after its corner fill on
        `grid` (vector=False)."""
        SI, SJ, SA, _, MASK = corner_ops._fill_corners_vector_perm(
            Domain.whole(self.n, self.h), grid)[tgt]
        out = self.get(base, t, i, j)[:, tgt].copy()
        m = MASK[i, j]
        if m.any():
            # an unsigned pair: every entry's sign is 1
            src = self.get(base, t[m], SI[i[m], j[m]], SJ[i[m], j[m]])
            out[m] = np.where(SA[i[m], j[m]] == 0, src[:, 0], src[:, 1])
        return out

    # -- 4. dxa / dya ---------------------------------------------------------
    def _dxadya_pre(self, t, i, j):
        M = self.M
        out = np.zeros(np.shape(t) + (2,))
        m = (i < M - 1) & (j < M - 1)
        if m.any():
            t, i, j = t[m], i[m], j[m]

            def ymid(di):
                return gnomonic.xyz_midpoint(self._at("dg", t, i, j, di),
                                             self._at("dg", t, i, j, di, 1))

            def xmid(dj):
                return gnomonic.xyz_midpoint(self._at("dg", t, i, j, 0, dj),
                                             self._at("dg", t, i, j, 1, dj))

            out[m, 0] = _gcd_xyz(ymid(0), ymid(1))
            out[m, 1] = _gcd_xyz(xmid(0), xmid(1))
        return out

    def _dxadya_cf(self, t, i, j):
        return np.stack([self._corner_vector_of("dxadya_pre", k, "A", t, i, j)
                         for k in (0, 1)], axis=-1)

    def _dxadya(self, t, i, j):
        return np.abs(self._pair("dxadya_cf", "center", "center", t, i, j))

    # -- 5. dxc / dyc ---------------------------------------------------------
    def _dxcdyc_pre(self, t, i, j):
        """(dxc, dyc) before their halo fill: the distance between the
        centers either side of the interface on lines 1..M-2 (line 0 and
        M-1 copy lines 1 and M-2), and on the tile's border lines twice the
        distance from the edge's midpoint to the first center inside."""
        h, n, M = self.h, self.n, self.M
        out = np.zeros(np.shape(t) + (2,))
        for k in (0, 1):
            a, b = (i, j) if k == 0 else (j, i)
            # across the interface (ci, cj), along the tile's border (di, dj)
            ci, cj = (1, 0) if k == 0 else (0, 1)
            di, dj = cj, ci
            for sel, shift in (((a >= 1) & (a <= M - 2), 0), (a == 0, 1),
                               (a == M - 1, -1)):
                sel = sel & (b < M - 1)
                if sel.any():
                    tt = t[sel]
                    ii, jj = i[sel] + shift * ci, j[sel] + shift * cj
                    out[sel, k] = _gcd_xyz(
                        self._at("ag", tt, ii, jj, -ci, -cj),
                        self._at("ag", tt, ii, jj))
            for line, inner in ((h, 0), (h + n, -1)):
                sel = (a == line) & (b >= h) & (b < h + n)
                if sel.any():
                    dg = functools.partial(self._at, "dg", t[sel], i[sel],
                                           j[sel])
                    mid = gnomonic.xyz_midpoint(dg(), dg(di, dj))
                    out[sel, k] = 2.0 * _gcd_xyz(mid, self._at(
                        "ag", t[sel], i[sel], j[sel], inner * ci,
                        inner * cj))
        return out

    def _dxcdyc_h(self, t, i, j):
        return np.abs(self._pair("dxcdyc_pre", "x_iface", "y_iface", t, i, j))

    def _dxc(self, t, i, j):
        return self._corner_vector_of("dxcdyc_h", 0, "C", t, i, j)

    def _dyc(self, t, i, j):
        return self._corner_vector_of("dxcdyc_h", 1, "C", t, i, j)

    # -- 6. area / area_c -----------------------------------------------------
    def _area_pre(self, t, i, j):
        h, n = self.h, self.n

        def fn(t, i, j):
            dg = functools.partial(self._at, "dg", t, i, j)
            return _rect(dg(), dg(0, 1), dg(1, 1), dg(1, 0))

        return self._fill((), -BIG_NUMBER, t, i, j,
                          (i >= h) & (i < h + n) & (j >= h) & (j < h + n), fn)

    def _area(self, t, i, j):
        return self.get("area_pre", *self.topo.scalar_source_at(
            "center", t, i, j))

    def _area_c_pre(self, t, i, j):
        h, n = self.h, self.n
        isc, ise = h, h + n
        out = np.zeros(np.shape(t))
        inside = (i >= h) & (i <= h + n) & (j >= h) & (j <= h + n)
        south = inside & (j == isc)
        east = inside & (i == ise) & ~south
        north = inside & (j == ise) & ~south & ~east
        west = inside & (i == isc) & ~south & ~east & ~north
        interior = inside & ~(south | east | north | west)

        def rule(sel, fn):
            if sel.any():
                out[sel] = fn(t[sel], i[sel], j[sel])

        def middle(t, i, j):
            ag = functools.partial(self._at, "ag", t, i, j)
            return _rect(ag(-1, -1), ag(-1, 0), ag(0, 0), ag(0, -1))

        def edge(di, dj, ci, cj):
            """2 x the one-sided area of the C cell at a border point: the
            border line runs along (di, dj); (ci, cj) is the offset of the
            centers inside."""
            def fn(t, i, j):
                dg = functools.partial(self._at, "dg", t, i, j)
                ag = functools.partial(self._at, "ag", t, i, j)
                lo = 0.5 * (dg(-di, -dj) + dg())
                hi = 0.5 * (dg() + dg(di, dj))
                return 2.0 * _rect(lo, ag(ci - di, cj - dj), ag(ci, cj), hi)

            return fn

        rule(interior, middle)
        rule(west, edge(0, 1, 0, 0))
        rule(north, edge(1, 0, 0, -1))
        rule(east, edge(0, 1, -1, 0))
        rule(south, edge(1, 0, 0, 0))
        return out

    def _area_c(self, t, i, j):
        t, i, j = self._corner_2d("B", "x", t, i, j)
        return self.get("area_c_pre", *self.topo.scalar_source_at(
            "corner", t, i, j))

    # -- 7. unit vectors ------------------------------------------------------
    def _ec(self, which, t, i, j):
        M = self.M

        def fn(t, i, j):
            dg = functools.partial(self._at, "dg", t, i, j)
            if which == 1:
                p1 = gnomonic.xyz_midpoint(dg(), dg(0, 1))
                p2 = gnomonic.xyz_midpoint(dg(1, 0), dg(1, 1))
            else:
                p1 = gnomonic.xyz_midpoint(dg(), dg(1, 0))
                p2 = gnomonic.xyz_midpoint(dg(0, 1), dg(1, 1))
            p3 = np.cross(p2, p1)
            return geometry.normalize_xyz(np.cross(
                self.get("center", t, i, j), p3))

        sel = (i < M - 1) & (j < M - 1) & ~self._wedge(i, j)
        return self._fill((3,), BIG_NUMBER, t, i, j, sel, fn)

    def _ec1(self, t, i, j):
        return self._ec(1, t, i, j)

    def _ec2(self, t, i, j):
        return self._ec(2, t, i, j)

    def _iface_vectors(self, axis, t, i, j):
        """(e?1, e?2) at x-interfaces (axis 0: ew1, ew2) or y-interfaces
        (axis 1: es1, es2), as (P, 6)."""
        h, n, M = self.h, self.n, self.M
        isc, ise = h, h + n
        a, b = (i, j) if axis == 0 else (j, i)
        sel = (a >= 1) & (a < M - 1) & (b < M - 1) & ~self._wedge(i, j)

        def fn(t, i, j):
            dg = functools.partial(self._at, "dg", t, i, j)
            ag = functools.partial(self._at, "ag", t, i, j)
            di, dj = (0, 1) if axis == 0 else (1, 0)   # along the line
            ci, cj = (1, 0) if axis == 0 else (0, 1)   # across it
            pp = gnomonic.xyz_midpoint(dg(), dg(di, dj))
            line = i if axis == 0 else j
            p2 = np.empty_like(pp)
            m = (line != isc) & (line != ise)
            p2[m] = np.cross(ag(-ci, -cj)[m], ag()[m])
            m = line == isc
            p2[m] = np.cross(pp[m], ag()[m])
            m = line == ise
            p2[m] = np.cross(ag(-ci, -cj)[m], pp[m])
            across = geometry.normalize_xyz(np.cross(p2, pp))
            along = geometry.normalize_xyz(np.cross(np.cross(dg(), dg(di, dj)),
                                                    pp))
            # ew1 is across the x-interface line, es1 along the y one
            first, second = (across, along) if axis == 0 else (along, across)
            return np.concatenate([first, second], axis=-1)

        return self._fill((6,), 0.0, t, i, j, sel, fn)

    def _ew(self, t, i, j):
        return self._iface_vectors(0, t, i, j)

    def _es(self, t, i, j):
        return self._iface_vectors(1, t, i, j)

    # -- 8. supergrid trig ----------------------------------------------------
    def _cos_pre(self, t, i, j):
        M = self.M

        def fn(t, i, j):
            dg = functools.partial(self._at, "dg", t, i, j)
            ag = self.get("ag", t, i, j)
            sc = geometry.spherical_cos
            out = np.empty(np.shape(t) + (9,))
            out[:, 5] = sc(dg(), dg(1, 0), dg(0, 1))
            out[:, 6] = -sc(dg(1, 0), dg(), dg(1, 1))
            out[:, 7] = sc(dg(1, 1), dg(1, 0), dg(0, 1))
            out[:, 8] = -sc(dg(0, 1), dg(), dg(1, 1))
            mid = gnomonic.xyz_midpoint
            out[:, 0] = sc(mid(dg(), dg(0, 1)), ag, dg(0, 1))
            out[:, 1] = sc(mid(dg(), dg(1, 0)), dg(1, 0), ag)
            out[:, 2] = sc(mid(dg(1, 0), dg(1, 1)), ag, dg(1, 0))
            out[:, 3] = sc(mid(dg(0, 1), dg(1, 1)), dg(0, 1), ag)
            out[:, 4] = (self.get("ec1", t, i, j)
                         * self.get("ec2", t, i, j)).sum(-1)
            return out

        out = self._fill((9,), BIG_NUMBER, t, i, j,
                         (i < M - 1) & (j < M - 1), fn)
        out[np.abs(1.0 - out) < 1e-15] = 1.0
        return out

    def _sin_pre(self, t, i, j):
        cos = self.get("cos_pre", t, i, j)
        return np.minimum(np.sqrt(np.clip(1.0 - cos ** 2, 0.0, None)), 1.0)

    def _rotated(self, table, base, t, i, j, wedge_value=None):
        """`base` with the rows of a rotation table applied (and, with
        `wedge_value`, the corner wedges [0, h) and [h + n, h + 2 h) of
        both axes set to it first)."""
        out = self.get(base, t, i, j).copy()
        if wedge_value is not None:
            out[self._wedge(i, j, self.h + self.n + self.h)] = wedge_value
        for (ti, tj), rows in table.items():
            m = (i == ti) & (j == tj)
            if not m.any():
                continue
            for tc, si, sj, sc in rows:
                src = self.get(base, t[m], np.full(m.sum(), si),
                               np.full(m.sum(), sj))
                out[m, tc] = src[:, sc]
        return out

    def _sin_adj(self, t, i, j):
        return self._rotated(self._adjust, "sin_pre", t, i, j)

    def _sin_sg(self, t, i, j):
        return self._rotated(self._fix, "sin_adj", t, i, j, TINY_NUMBER)

    def _cos_sg(self, t, i, j):
        return self._rotated(self._fix, "cos_pre", t, i, j, BIG_NUMBER)

    # -- 9. derived trig ------------------------------------------------------
    def _cosa_sina(self, t, i, j):
        h, n = self.h, self.n

        def fn(t, i, j):
            c0, c1 = self._at("cos_pre", t, i, j, -1, -1), self._at(
                "cos_pre", t, i, j)
            s0, s1 = self._at("sin_adj", t, i, j, -1, -1), self._at(
                "sin_adj", t, i, j)
            return np.stack([0.5 * (c0[:, 7] + c1[:, 5]),
                             0.5 * (s0[:, 7] + s1[:, 5])], axis=-1)

        sel = (i >= h) & (i <= h + n) & (j >= h) & (j <= h + n)
        return self._fill((2,), BIG_NUMBER, t, i, j, sel, fn)

    def _uv_trig(self, axis, t, i, j):
        """(cosa_u, sina_u, rsin_u) (axis 0) or the v ones (axis 1)."""
        h, n, M = self.h, self.n, self.M
        a = i if axis == 0 else j
        lo_c, hi_c = (2, 0) if axis == 0 else (3, 1)

        def fn(t, i, j):
            di, dj = (-1, 0) if axis == 0 else (0, -1)
            c0, c1 = self._at("cos_pre", t, i, j, di, dj), self._at(
                "cos_pre", t, i, j)
            s0, s1 = self._at("sin_adj", t, i, j, di, dj), self._at(
                "sin_adj", t, i, j)
            cosa = 0.5 * (c0[:, lo_c] + c1[:, hi_c])
            sina = 0.5 * (s0[:, lo_c] + s1[:, hi_c])
            rsin = 1.0 / np.maximum(sina ** 2, TINY_NUMBER)
            line = i if axis == 0 else j
            edge = (line == h) | (line == h + n)
            rsin[edge] = _limited_inverse(sina[edge])
            return np.stack([cosa, sina, rsin], axis=-1)

        return self._fill((3,), BIG_NUMBER, t, i, j, (a >= 1) & (a < M - 1),
                          fn)

    def _u_trig(self, t, i, j):
        return self._uv_trig(0, t, i, j)

    def _v_trig(self, t, i, j):
        return self._uv_trig(1, t, i, j)

    def _trig(self, name, t, i, j):
        if name in ("cosa", "sina"):
            return self.get("cosa_sina", t, i, j)[:, int(name == "sina")]
        if name in ("cosa_u", "sina_u", "rsin_u", "cosa_v", "sina_v",
                    "rsin_v"):
            k = ("cosa", "sina", "rsin").index(name[:-2])
            return self.get(f"{name[-1]}_trig", t, i, j)[:, k]
        if name == "cosa_s":
            out = self.get("cos_pre", t, i, j)[:, 4].copy()
            out[self._wedge(i, j)] = BIG_NUMBER
            return out
        if name == "rsin2":
            return 1.0 / np.maximum(self.get("sin_adj", t, i, j)[:, 4] ** 2,
                                    TINY_NUMBER)
        if name == "rsina":
            h, n = self.h, self.n
            sel = ((i > h) & (i < h + n) & (j > h) & (j < h + n))
            return self._fill((), BIG_NUMBER, t, i, j, sel, lambda t, i, j: (
                1.0 / np.maximum(self.get("cosa_sina", t, i, j)[:, 1] ** 2,
                                 TINY_NUMBER)))
        raise KeyError(name)

    # -- 10. l2c, ee ----------------------------------------------------------
    def _l2c(self, axis, t, i, j):
        """l2c_u (axis 0: along i) or l2c_v (axis 1: along j)."""
        h, n = self.h, self.n
        a, b = (i, j) if axis == 0 else (j, i)
        sel = (a >= h) & (a < h + n) & (b >= h) & (b <= h + n)

        def fn(t, i, j):
            di, dj = (1, 0) if axis == 0 else (0, 1)
            p1 = self._at("grid", t, i, j)
            p2 = self._at("grid", t, i, j, di, dj)
            midlon, midlat = geometry.lon_lat_midpoint(
                p1[..., 0], p2[..., 0], p1[..., 1], p2[..., 1])
            unit_dir = geometry.get_unit_vector_direction(p1, p2)
            ex, _ = geometry.lonlat_unit_vectors(midlon, midlat)
            return np.cos(midlat) * (unit_dir * ex).sum(-1)

        return self._fill((), 0.0, t, i, j, sel, fn)

    def _ee(self, axis, t, i, j):
        h, n = self.h, self.n
        sel = (i >= h) & (i <= h + n) & (j >= h) & (j <= h + n)

        def fn(t, i, j):
            dg = functools.partial(self._at, "dg", t, i, j)
            di, dj = (1, 0) if axis == 0 else (0, 1)
            line = i if axis == 0 else j
            cv = np.cross(dg(-di, -dj), dg(di, dj))
            m = line == h
            cv[m] = np.cross(dg()[m], dg(di, dj)[m])
            m = line == h + n
            cv[m] = np.cross(dg(-di, -dj)[m], dg()[m])
            return geometry.normalize_xyz(np.cross(cv, dg()))

        return self._fill((3,), np.nan, t, i, j, sel, fn)

    # -- 11. divergence damping -----------------------------------------------
    def _damping_pre(self, t, i, j):
        """(divg_v, divg_u, del6_v, del6_u) before their halo fill."""
        h, n = self.h, self.n
        sina_u = self.get("u_trig", t, i, j)[:, 1]
        sina_v = self.get("v_trig", t, i, j)[:, 1]
        dx, dy = self.get("dx", t, i, j), self.get("dy", t, i, j)
        dxc, dyc = self.get("dxc", t, i, j), self.get("dyc", t, i, j)
        out = np.empty(np.shape(t) + (4,))
        with np.errstate(divide="ignore", invalid="ignore"):
            divg_u = sina_v * dyc / dx
            del6_u = sina_v * dx / dyc
            divg_v = sina_u * dxc / dy
            del6_v = sina_u * dy / dxc
            for line, lo in ((h, h - 1), (h + n, h + n - 1)):
                m = j == line
                if m.any():
                    s = 0.5 * (self.get("sin_sg", t[m], i[m], j[m])[:, 1]
                               + self.get("sin_sg", t[m], i[m],
                                          np.full(m.sum(), lo))[:, 3])
                    divg_u[m] = s * dyc[m] / dx[m]
                    del6_u[m] = s * dx[m] / dyc[m]
                m = i == line
                if m.any():
                    s = 0.5 * (self.get("sin_sg", t[m], i[m], j[m])[:, 0]
                               + self.get("sin_sg", t[m],
                                          np.full(m.sum(), lo), j[m])[:, 2])
                    divg_v[m] = s * dxc[m] / dy[m]
                    del6_v[m] = s * dy[m] / dxc[m]
        out[:, 0], out[:, 1], out[:, 2], out[:, 3] = (divg_v, divg_u, del6_v,
                                                      del6_u)
        return out

    def _divg_pre(self, t, i, j):
        return self.get("damping_pre", t, i, j)[:, :2]

    def _del6_pre(self, t, i, j):
        return self.get("damping_pre", t, i, j)[:, 2:]

    def _divg(self, t, i, j):
        return np.abs(self._pair("divg_pre", "x_iface", "y_iface", t, i, j))

    def _del6(self, t, i, j):
        return np.abs(self._pair("del6_pre", "x_iface", "y_iface", t, i, j))

    # -- 12. lat-lon transform ------------------------------------------------
    def _vlonlat(self, t, i, j):
        a = self.get("agrid", t, i, j)
        with np.errstate(invalid="ignore"):
            vlon, vlat = geometry.lonlat_unit_vectors(a[:, 0], a[:, 1])
        return np.concatenate([vlon, vlat], axis=-1)

    def _z(self, t, i, j):
        """(z11, z12, z21, z22)."""
        ec1, ec2 = self.get("ec1", t, i, j), self.get("ec2", t, i, j)
        v = self.get("vlonlat", t, i, j)
        vlon, vlat = v[:, :3], v[:, 3:]
        return np.stack([(ec1 * vlon).sum(-1), (ec1 * vlat).sum(-1),
                         (ec2 * vlon).sum(-1), (ec2 * vlat).sum(-1)],
                        axis=-1)

    def _a(self, t, i, j):
        """(a11, a12, a21, a22)."""
        z = self.get("z", t, i, j)
        z11, z12, z21, z22 = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
        sin5 = self.get("sin_sg", t, i, j)[:, 4]
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.stack([0.5 * z22 / sin5, -0.5 * z12 / sin5,
                             -0.5 * z21 / sin5, 0.5 * z11 / sin5], axis=-1)

    # -- the terms by their bundle names --------------------------------------
    def term(self, name: str, t, i, j) -> np.ndarray:
        """Term `name` of `_metric_terms`' horizontal, angle or damping
        bundle at the points (t, i, j)."""
        t, i, j = (np.asarray(a, np.int64) for a in np.broadcast_arrays(
            t, i, j))
        shape = t.shape
        t, i, j = t.ravel(), i.ravel(), j.ravel()
        out = self._term(name, t, i, j)
        return out.reshape(shape + out.shape[1:])

    _PAIRS = {"lon": ("grid", 0), "lat": ("grid", 1),
              "lon_agrid": ("agrid", 0), "lat_agrid": ("agrid", 1),
              "dxa": ("dxadya", 0), "dya": ("dxadya", 1),
              "ew1": ("ew", slice(0, 3)), "ew2": ("ew", slice(3, 6)),
              "es1": ("es", slice(0, 3)), "es2": ("es", slice(3, 6)),
              "vlon": ("vlonlat", slice(0, 3)),
              "vlat": ("vlonlat", slice(3, 6)),
              "z11": ("z", 0), "z12": ("z", 1), "z21": ("z", 2),
              "z22": ("z", 3), "a11": ("a", 0), "a12": ("a", 1),
              "a21": ("a", 2), "a22": ("a", 3),
              "divg_v": ("divg", 0), "divg_u": ("divg", 1),
              "del6_v": ("del6", 0), "del6_u": ("del6", 1)}
    _INVERSES = {"rarea": "area", "rarea_c": "area_c", "rdx": "dx",
                 "rdy": "dy", "rdxc": "dxc", "rdyc": "dyc", "rdxa": "dxa",
                 "rdya": "dya"}

    def _term(self, name, t, i, j):
        if name in self._PAIRS:
            base, k = self._PAIRS[name]
            return self.get(base, t, i, j)[:, k]
        if name in self._INVERSES:
            return _safe_inv(self._term(self._INVERSES[name], t, i, j))
        if name in ("dx", "dy", "dxc", "dyc", "area", "area_c", "ec1", "ec2",
                    "cos_sg", "sin_sg"):
            return self.get(name, t, i, j)
        if name in ("ee1", "ee2"):
            return self._ee(int(name[-1]) - 1, t, i, j)
        if name in ("l2c_u", "l2c_v"):
            return self._l2c(0 if name == "l2c_u" else 1, t, i, j)
        if name == "fC":
            return 2.0 * OMEGA * np.sin(self._term("lat", t, i, j))
        if name == "f0":
            return 2.0 * OMEGA * np.sin(self._term("lat_agrid", t, i, j))
        return self._trig(name, t, i, j)

    # -- 13. edge tables ------------------------------------------------------
    def edge(self, name: str, t, k) -> np.ndarray:
        """Entries `k` (storage indices along the edge) of tiles `t` of
        the edge table `name` (edge_w ... edge_vect_n)."""
        t, k = (np.asarray(a, np.int64) for a in np.broadcast_arrays(t, k))
        shape = t.shape
        t, k = t.ravel(), k.ravel()
        h, n = self.h, self.n
        side = name[-1]
        # (the line's index, the outer and the inner center lines) across
        # the edge; along it the other storage axis
        line, outer, inner = ((h, h - 1, h) if side in "ws"
                              else (h + n, h + n, h + n - 1))

        vect = name.startswith("edge_vect")
        # the interior entries; the ends of an edge_vect table continue its
        # first and last interior ones
        sel = ((k >= h - 1) & (k <= h + n) if vect
               else (k >= h + 1) & (k < h + n))
        t, c = t[sel], (np.clip(k, h, h + n - 1) if vect else k)[sel]

        def at(field, across, along):
            other = np.full(along.shape, across)
            return self.get(field, t, *((other, along) if side in "we"
                                        else (along, other)))

        def mid(field, a, b, c0, c1):
            """lon_lat_midpoint of `field` at (a, c0) and (b, c1)."""
            p, q = at(field, a, c0), at(field, b, c1)
            return geometry.lon_lat_midpoint(p[:, 0], q[:, 0], p[:, 1],
                                             q[:, 1])

        out = np.full(shape, BIG_NUMBER).ravel()
        if vect:
            p2 = mid("grid", line, line, c, c + 1)
            here = mid("agrid", outer, inner, c, c)
            nbr = np.where(c - h + 1 <= n // 2, c + 1, c - 1)
            other = mid("agrid", outer, inner, nbr, nbr)
            d1 = _gcd(here[0], p2[0], here[1], p2[1])
            d2 = _gcd(other[0], p2[0], other[1], p2[1])
            out[sel] = d1 / (d2 + d1)
        else:
            g = at("grid", line, c)
            m0 = mid("agrid", outer, inner, c - 1, c - 1)
            m1 = mid("agrid", outer, inner, c, c)
            d1 = _gcd(m0[0], g[:, 0], m0[1], g[:, 1])
            d2 = _gcd(m1[0], g[:, 0], m1[1], g[:, 1])
            out[sel] = d2 / (d1 + d2)
        return out.reshape(shape)

    # -- the four extremes ----------------------------------------------------
    def area_extremes(self) -> dict:
        """da_min, da_max, da_min_c and da_max_c: the extremes of area and
        area_c over every tile's compute cells (min and max do not depend
        on order), one tile at a time in a store of its own.  Inside the
        tile's border lines both are the whole-array forms of
        `_metric_terms` on the tile's compute corners and centers, which
        need no halo; area_c on the south and west lines is `term`'s."""
        h, n = self.h, self.n
        lo = {"area": np.inf, "area_c": np.inf}
        hi = {"area": -np.inf, "area_c": -np.inf}
        for t in range(6):
            tile = PointMetrics.__new__(PointMetrics)
            tile.__dict__.update(self.__dict__, _store={})

            def grid(lo, size):
                i, j = np.meshgrid(np.arange(lo, lo + size),
                                   np.arange(lo, lo + size), indexing="ij")
                return np.full(i.shape, t), i, j

            area = geometry.cell_area_from_corners(
                tile.get("dg", *grid(h, n + 1)), RADIUS)
            inner = geometry.cell_area_from_corners(
                tile.get("ag", *grid(h, n)), RADIUS)
            _, i, j = grid(h, n)
            lines = (i == h) | (j == h)
            border = tile.term("area_c", np.full(lines.sum(), t), i[lines],
                               j[lines])
            for name, values in (("area", area), ("area_c", inner),
                                 ("area_c", border)):
                lo[name] = min(lo[name], float(values.min()))
                hi[name] = max(hi[name], float(values.max()))
        return dict(da_min=lo["area"], da_max=hi["area"],
                    da_min_c=lo["area_c"], da_max_c=hi["area_c"])


@functools.lru_cache(maxsize=4)
def area_extremes(n: int, halo: int, stretch_factor, lon_target,
                  lat_target) -> dict:
    """`PointMetrics(...).area_extremes()`, once per grid."""
    return PointMetrics(n, halo, stretch_factor, lon_target,
                        lat_target).area_extremes()


class PointView:
    """The raw metric terms at points in the nested layout of
    `_metric_terms`' result: `view["horizontal"]["lon"][t, i, j]` with
    int arrays or slices (of one kind per call) evaluates the term
    there."""

    def __init__(self, metrics: PointMetrics):
        self.metrics = metrics

    def __getitem__(self, bundle: str):
        if bundle not in ("horizontal", "angle", "damping"):
            raise KeyError(bundle)
        return _Bundle(self.metrics)


class _Bundle:
    def __init__(self, metrics):
        self.metrics = metrics

    def __getitem__(self, name):
        return _Term(self.metrics, name)


class _Term:
    def __init__(self, metrics, name):
        self.metrics, self.name = metrics, name

    def __getitem__(self, index):
        t, i, j = index
        if all(isinstance(a, slice) for a in index):
            t, i, j = np.meshgrid(*(np.arange(s.start, s.stop)
                                    for s in index), indexing="ij")
        return self.metrics.term(self.name, t, i, j)
