"""Fourth-order A-grid (cell center) to B-grid (cell corner) interpolation.

Port of `pace_tpu.ops.a2b_ord4` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/a2b_ord4.py `AGrid2BGridFourthOrder`): interior 4-point Lagrange interpolation of PPM
volume means, one-sided edge treatments at tile edges, geometric
extrapolation at the four cube corners.
"""

from __future__ import annotations

import torch

from pace_torch.ops import stencil_utils as su
from pace_torch.ops.stencil_utils import set_region, shift

# compact 4-pt cubic interpolation
C1 = 2.0 / 3.0
C2 = -1.0 / 6.0
# PPM volume mean form
B1 = 7.0 / 12.0
B2 = -1.0 / 12.0
# 4-pt Lagrange interpolation
A1 = 9.0 / 16.0
A2 = -1.0 / 16.0


def _gcd(p1a, p1b, p2a, p2b):
    tb = torch.sin((p1b - p2b) / 2.0) ** 2
    ta = torch.sin((p1a - p2a) / 2.0) ** 2
    return torch.arcsin(torch.sqrt(tb + torch.cos(p1b) * torch.cos(p2b) * ta)) * 2.0


def _extrap_corner(p0a, p0b, p1a, p1b, p2a, p2b, qa, qb):
    x1 = _gcd(p1a, p1b, p0a, p0b)[..., None]
    x2 = _gcd(p2a, p2b, p0a, p0b)[..., None]
    return qa + x1 / (x2 - x1) * (qa - qb)


def _corner_value(qin, lon, lat, lon_a, lat_a, ci, cj, offsets):
    """3-way extrapolated corner value at B-point (ci, cj); offsets is a list
    of ((i1,j1),(i2,j2)) A-grid point pairs relative to (ci, cj)."""
    vals = []
    p0a = lon[:, ci, cj]
    p0b = lat[:, ci, cj]
    for (i1, j1), (i2, j2) in offsets:
        vals.append(_extrap_corner(
            p0a, p0b,
            lon_a[:, ci + i1, cj + j1], lat_a[:, ci + i1, cj + j1],
            lon_a[:, ci + i2, cj + j2], lat_a[:, ci + i2, cj + j2],
            qin[:, ci + i1, cj + j1], qin[:, ci + i2, cj + j2],
        ))
    return (vals[0] + vals[1] + vals[2]) / 3.0


def _set_point(q, i, j, value):
    out = q.clone()
    out[:, i, j] = value
    return out


def a2b_ord4(qin: torch.Tensor, gd, dom) -> torch.Tensor:
    """Interpolate a cell-centered field to cell corners (B grid).

    Valid on corner points [h, h+n] in both directions (the full tile
    interface grid); outside that the output is unspecified.
    """
    n, h = dom.n, dom.h
    hz = gd.horizontal
    lon, lat = hz.lon, hz.lat
    lon_a, lat_a = hz.lon_agrid, hz.lat_agrid
    dxa = hz.dxa[..., None]
    dya = hz.dya[..., None]

    qout = torch.zeros_like(qin)

    # --- four cube corners (reference _sw/_nw/_ne/_se corner stencils) ----
    # each where the block holds the corner and the cells it reads
    for ci, cj, offsets in (
        (h, h, [((0, 0), (1, 1)), ((-1, 0), (-2, 1)), ((0, -1), (1, -2))]),
        (h + n, h,
         [((-1, 0), (-2, 1)), ((-1, -1), (-2, -2)), ((0, 0), (1, 1))]),
        (h + n, h + n,
         [((-1, -1), (-2, -2)), ((0, -1), (1, -2)), ((-1, 0), (-2, 1))]),
        (h, h + n,
         [((0, -1), (1, -2)), ((-1, -1), (-2, -2)), ((0, 0), (1, 1))]),
    ):
        li, lj = dom.col(ci), dom.row(cj)
        if (li is None or lj is None or dom.col(ci - 2) is None
                or dom.col(ci + 1) is None or dom.row(cj - 2) is None
                or dom.row(cj + 1) is None):
            continue
        qout = _set_point(qout, li, lj, _corner_value(
            qin, lon, lat, lon_a, lat_a, li, lj, offsets))
    tmp_edges = qout

    # --- tile-edge B points (qout_x_edge / qout_y_edge) --------------------
    jm = slice(h + 1, h + n)  # interior edge points
    # west (i = h): q2 = dxa-weighted i-average of qin
    q2 = (shift(qin, -1) * dxa + qin * shift(dxa, -1)) / (shift(dxa, -1) + dxa)
    ew = hz.edge_w[:, None, :, None]  # (6, 1, N, 1), along j
    val = ew * shift(q2, 0, -1) + (1.0 - ew) * q2
    qout = su.upd_point(dom, qout, val, h, jm)
    ee = hz.edge_e[:, None, :, None]
    val = ee * shift(q2, 0, -1) + (1.0 - ee) * q2
    qout = su.upd_point(dom, qout, val, h + n, jm)
    # south (j = h)
    q1 = (shift(qin, 0, -1) * dya + qin * shift(dya, 0, -1)) / (
        shift(dya, 0, -1) + dya
    )
    es = hz.edge_s[:, :, None, None]
    val = es * shift(q1, -1) + (1.0 - es) * q1
    qout = su.upd_point(dom, qout, val, jm, h)
    en = hz.edge_n[:, :, None, None]
    val = en * shift(q1, -1) + (1.0 - en) * q1
    qout = su.upd_point(dom, qout, val, jm, h + n)
    tmp_edges = su.upd_cols(dom, tmp_edges, qout, h, h + n)
    tmp_edges = su.upd_rows(dom, tmp_edges, qout, h)
    tmp_edges = su.upd_rows(dom, tmp_edges, qout, h + n)

    # --- PPM volume means on interfaces (qx, qy) ---------------------------
    qx = B2 * (shift(qin, -2) + shift(qin, 1)) + B1 * (shift(qin, -1) + qin)
    # one-sided/edge variants at i = h, h+1, h+n-1, h+n
    g_in = shift(dxa, 1) / dxa
    g_ou = shift(dxa, -2) / shift(dxa, -1)
    qx_w = 0.5 * (
        ((2.0 + g_in) * qin - shift(qin, 1)) / (1.0 + g_in)
        + ((2.0 + g_ou) * shift(qin, -1) - shift(qin, -2)) / (1.0 + g_ou)
    )
    qx = su.upd_cols(dom, qx, qx_w, h)
    g_in2 = dxa / shift(dxa, -1)
    g_ou2 = shift(dxa, -3) / shift(dxa, -2)
    qxleft = 0.5 * (
        ((2.0 + g_in2) * shift(qin, -1) - qin) / (1.0 + g_in2)
        + ((2.0 + g_ou2) * shift(qin, -2) - shift(qin, -3)) / (1.0 + g_ou2)
    )
    qxright = B2 * (shift(qin, -1) + shift(qin, 2)) + B1 * (qin + shift(qin, 1))
    qx_w2 = (
        3.0 * (g_in2 * shift(qin, -1) + qin) - (g_in2 * qxleft + qxright)
    ) / (2.0 + 2.0 * g_in2)
    qx = su.upd_cols(dom, qx, qx_w2, h + 1)
    g_in = shift(dxa, -2) / shift(dxa, -1)
    g_ou = shift(dxa, 1) / dxa
    qx_e = 0.5 * (
        ((2.0 + g_in) * shift(qin, -1) - shift(qin, -2)) / (1.0 + g_in)
        + ((2.0 + g_ou) * qin - shift(qin, 1)) / (1.0 + g_ou)
    )
    qx = su.upd_cols(dom, qx, qx_e, h + n)
    g_in2 = shift(dxa, -1) / dxa
    g_ou2 = shift(dxa, 2) / shift(dxa, 1)
    qxright2 = 0.5 * (
        ((2.0 + g_in2) * qin - shift(qin, -1)) / (1.0 + g_in2)
        + ((2.0 + g_ou2) * shift(qin, 1) - shift(qin, 2)) / (1.0 + g_ou2)
    )
    qxleft2 = B2 * (shift(qin, -3) + qin) + B1 * (shift(qin, -2) + shift(qin, -1))
    qx_e2 = (
        3.0 * (shift(qin, -1) + g_in2 * qin) - (g_in2 * qxright2 + qxleft2)
    ) / (2.0 + 2.0 * g_in2)
    qx = su.upd_cols(dom, qx, qx_e2, h + n - 1)

    qy = B2 * (shift(qin, 0, -2) + shift(qin, 0, 1)) + B1 * (shift(qin, 0, -1) + qin)
    g_in = shift(dya, 0, 1) / dya
    g_ou = shift(dya, 0, -2) / shift(dya, 0, -1)
    qy_s = 0.5 * (
        ((2.0 + g_in) * qin - shift(qin, 0, 1)) / (1.0 + g_in)
        + ((2.0 + g_ou) * shift(qin, 0, -1) - shift(qin, 0, -2)) / (1.0 + g_ou)
    )
    qy = su.upd_rows(dom, qy, qy_s, h)
    g_in2 = dya / shift(dya, 0, -1)
    g_ou2 = shift(dya, 0, -3) / shift(dya, 0, -2)
    qy_lower = 0.5 * (
        ((2.0 + g_in2) * shift(qin, 0, -1) - qin) / (1.0 + g_in2)
        + ((2.0 + g_ou2) * shift(qin, 0, -2) - shift(qin, 0, -3)) / (1.0 + g_ou2)
    )
    qy_upper = B2 * (shift(qin, 0, -1) + shift(qin, 0, 2)) + B1 * (
        qin + shift(qin, 0, 1)
    )
    qy_s2 = (
        3.0 * (g_in2 * shift(qin, 0, -1) + qin) - (g_in2 * qy_lower + qy_upper)
    ) / (2.0 + 2.0 * g_in2)
    qy = su.upd_rows(dom, qy, qy_s2, h + 1)
    g_in = shift(dya, 0, -2) / shift(dya, 0, -1)
    g_ou = shift(dya, 0, 1) / dya
    qy_n = 0.5 * (
        ((2.0 + g_in) * shift(qin, 0, -1) - shift(qin, 0, -2)) / (1.0 + g_in)
        + ((2.0 + g_ou) * qin - shift(qin, 0, 1)) / (1.0 + g_ou)
    )
    qy = su.upd_rows(dom, qy, qy_n, h + n)
    g_in2 = shift(dya, 0, -1) / dya
    g_ou2 = shift(dya, 0, 2) / shift(dya, 0, 1)
    qy_lower2 = B2 * (shift(qin, 0, -3) + qin) + B1 * (
        shift(qin, 0, -2) + shift(qin, 0, -1)
    )
    qy_upper2 = 0.5 * (
        ((2.0 + g_in2) * qin - shift(qin, 0, -1)) / (1.0 + g_in2)
        + ((2.0 + g_ou2) * shift(qin, 0, 1) - shift(qin, 0, 2)) / (1.0 + g_ou2)
    )
    qy_n2 = (
        3.0 * (shift(qin, 0, -1) + g_in2 * qin) - (g_in2 * qy_upper2 + qy_lower2)
    ) / (2.0 + 2.0 * g_in2)
    qy = su.upd_rows(dom, qy, qy_n2, h + n - 1)

    # --- interior interpolation (a2b_interpolation) -------------------------
    qxx = A2 * (shift(qx, 0, -2) + shift(qx, 0, 1)) + A1 * (shift(qx, 0, -1) + qx)
    qyy = A2 * (shift(qy, -2) + shift(qy, 1)) + A1 * (shift(qy, -1) + qy)
    # row/column adjacent to tile edges use the compact form w/ edge values
    qxx_upper = A2 * (shift(qx, 0, -1) + shift(qx, 0, 2)) + A1 * (qx + shift(qx, 0, 1))
    qxx_j1 = C1 * (shift(qx, 0, -1) + qx) + C2 * (shift(tmp_edges, 0, -1) + qxx_upper)
    qxx = su.upd_rows(dom, qxx, qxx_j1, h + 1)
    qxx_lower = A2 * (shift(qx, 0, -3) + qx) + A1 * (shift(qx, 0, -2) + shift(qx, 0, -1))
    qxx_jn = C1 * (shift(qx, 0, -1) + qx) + C2 * (shift(tmp_edges, 0, 1) + qxx_lower)
    qxx = su.upd_rows(dom, qxx, qxx_jn, h + n - 1)
    qyy_right = A2 * (shift(qy, -1) + shift(qy, 2)) + A1 * (qy + shift(qy, 1))
    qyy_i1 = C1 * (shift(qy, -1) + qy) + C2 * (shift(tmp_edges, -1) + qyy_right)
    qyy = su.upd_cols(dom, qyy, qyy_i1, h + 1)
    qyy_left = A2 * (shift(qy, -3) + qy) + A1 * (shift(qy, -2) + shift(qy, -1))
    qyy_in = C1 * (shift(qy, -1) + qy) + C2 * (shift(tmp_edges, 1) + qyy_left)
    qyy = su.upd_cols(dom, qyy, qyy_in, h + n - 1)

    interior = 0.5 * (qxx + qyy)
    qout = set_region(
        dom, qout, slice(h + 1, h + n), slice(h + 1, h + n), interior
    )
    return qout
