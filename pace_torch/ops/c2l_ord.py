"""D-grid winds -> lat/lon A-grid winds (c2l_ord).

Port of `pace_tpu.ops.c2l_ord` (reference ai2cm/pace
stencils/pace/stencils/c2l_ord.py `CubedToLatLon`).
"""

from __future__ import annotations

from pace_torch.ops import stencil_utils as su
from pace_torch.ops.stencil_utils import shift
from pace_torch.parallel import halo as halo_mod

C1 = 1.125
C2 = -0.125


def cubed_to_latlon(u, v, gd, topo, order: int = 4, do_halo=True):
    """Returns (ua, va) lat/lon winds at cell centers of the block of
    `topo.domain`."""
    dom = topo.domain
    n, h = dom.n, dom.h
    hz = gd.horizontal
    dx = hz.dx[..., None]
    dy = hz.dy[..., None]
    a11 = hz.a11[..., None]
    a12 = hz.a12[..., None]
    a21 = hz.a21[..., None]
    a22 = hz.a22[..., None]
    if order == 2:
        wu = u * dx
        wv = v * dy
        u1 = 2.0 * (wu + shift(wu, 0, 1)) / (dx + shift(dx, 0, 1))
        v1 = 2.0 * (wv + shift(wv, 1)) / (dy + shift(dy, 1))
        return a11 * u1 + a12 * v1, a21 * u1 + a22 * v1, u, v

    if do_halo:
        u, v = halo_mod.halo_update_vector(topo, u, v, "y_iface", "x_iface")
    utmp = C2 * (shift(u, 0, -1) + shift(u, 0, 2)) + C1 * (u + shift(u, 0, 1))
    vtmp = C2 * (shift(v, -1) + shift(v, 2)) + C1 * (v + shift(v, 1))
    # tile-edge rows/columns use the area-weighted 2nd-order form
    u2 = 2.0 * (u * dx + shift(u, 0, 1) * shift(dx, 0, 1)) / (dx + shift(dx, 0, 1))
    v2 = 2.0 * (v * dy + shift(v, 1) * shift(dy, 1)) / (dy + shift(dy, 1))
    for j in (h, h + n - 1):
        utmp = su.upd_rows(dom, utmp, u2, j)
        vtmp = su.upd_rows(dom, vtmp, v2, j)
    for i in (h, h + n - 1):
        utmp = su.upd_cols(dom, utmp, u2, i)
        vtmp = su.upd_cols(dom, vtmp, v2, i)
    ua = a11 * utmp + a12 * vtmp
    va = a21 * utmp + a22 * vtmp
    return ua, va, u, v
