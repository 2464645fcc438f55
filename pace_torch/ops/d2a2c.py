"""D-grid -> A-grid -> C-grid wind staggering conversion (d2a2c_vect).

Port of `pace_tpu.ops.d2a2c` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/d2a2c_vect.py `DGrid2AGrid2CGridVectors`):
4th-order interpolation of D-grid winds to cell centers, contravariant
components there, then interpolation to C-grid interfaces with
volume-conserving cubics and 4-pt extrapolation at tile edges.  Cube-corner
wedges are filled with the rotated companion component.
"""

from __future__ import annotations

import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops import stencil_utils as su
from pace_torch.ops.a2b_ord4 import A1, A2
from pace_torch.ops.stencil_utils import shift as sh

C1 = -2.0 / 14.0
C2 = 11.0 / 14.0
C3 = 5.0 / 14.0
BIG_NUMBER = 1e30


def contravariant(v1, v2, cosa, rsin):
    """Contravariant wind component from covariant components (FV3 docs
    eqs. 3.4-3.5)."""
    return (v1 - v2 * cosa) * rsin


def _edge_interpolate4_x(ua, dxa):
    t1 = sh(dxa, -2) + sh(dxa, -1)
    t2 = dxa + sh(dxa, 1)
    n1 = (t1 + sh(dxa, -1)) * sh(ua, -1) - sh(dxa, -1) * sh(ua, -2)
    n2 = (t1 + dxa) * ua - dxa * sh(ua, 1)
    return 0.5 * (n1 / t1 + n2 / t2)


def _edge_interpolate4_y(va, dya):
    t1 = sh(dya, 0, -2) + sh(dya, 0, -1)
    t2 = dya + sh(dya, 0, 1)
    n1 = (t1 + sh(dya, 0, -1)) * sh(va, 0, -1) \
        - sh(dya, 0, -1) * sh(va, 0, -2)
    n2 = (t1 + dya) * va - dya * sh(va, 0, 1)
    return 0.5 * (n1 / t1 + n2 / t2)


def d2a2c_vect(u, v, gd, dom):
    """Returns (uc, vc, ua, va, ut, vt).

    ut/vt are the contravariant C-grid winds (utc/vtc in the reference).
    """
    n, h = dom.n, dom.h
    hz, ang = gd.horizontal, gd.angle
    cosa_s = ang.cosa_s[..., None]
    rsin2 = ang.rsin2[..., None]
    cosa_u = ang.cosa_u[..., None]
    rsin_u = ang.rsin_u[..., None]
    cosa_v = ang.cosa_v[..., None]
    rsin_v = ang.rsin_v[..., None]
    dxa = hz.dxa[..., None]
    dya = hz.dya[..., None]
    sin_sg1 = ang.sin_sg[..., 0][..., None]
    sin_sg2 = ang.sin_sg[..., 1][..., None]
    sin_sg3 = ang.sin_sg[..., 2][..., None]
    sin_sg4 = ang.sin_sg[..., 3][..., None]

    npt = 4 if n > 4 else 0
    lo = npt + 2          # first interior index for the 4th-order average
    hi = h + n - npt + 2  # one-past-last (= nx - npt + 1 in ref coords)

    # D -> A: averages near edges, 4th-order Lagrange in the interior
    utmp = torch.full_like(u, BIG_NUMBER)
    vtmp = torch.full_like(v, BIG_NUMBER)
    u_avg = 0.5 * (u + sh(u, 0, 1))
    v_avg = 0.5 * (v + sh(v, 1, 0))
    utmp = su.set_region(dom, utmp, slice(0, h + n + h), slice(0, h + n + h),
                          u_avg)
    vtmp = su.set_region(dom, vtmp, slice(0, h + n + h), slice(0, h + n + h),
                          v_avg)
    u_lag = A2 * (sh(u, 0, -1) + sh(u, 0, 2)) + A1 * (u + sh(u, 0, 1))
    v_lag = A2 * (sh(v, -1) + sh(v, 2)) + A1 * (v + sh(v, 1))
    interior = slice(lo, hi - 1)
    utmp = su.set_region(dom, utmp, interior, interior, u_lag)
    vtmp = su.set_region(dom, vtmp, interior, interior, v_lag)

    # contravariant components at cell centers
    ua = contravariant(utmp, vtmp, cosa_s, rsin2)
    va = contravariant(vtmp, utmp, cosa_s, rsin2)

    # x-direction corner fills
    utmp = _fill_cells(utmp, vtmp, dom, "x", 3)
    ua = _fill_cells(ua, va, dom, "x", 2)

    # A -> C on x-interfaces
    uc = A2 * (sh(utmp, -2) + sh(utmp, 1)) + A1 * (sh(utmp, -1) + utmp)
    cubic = C1 * sh(utmp, -2) + C2 * sh(utmp, -1) + C3 * utmp
    cubic_rev = C1 * sh(utmp, 1) + C2 * utmp + C3 * sh(utmp, -1)
    for i in (h - 1, h + n - 1):
        uc = su.upd_cols(dom, uc, cubic, i)
    for i in (h + 1, h + n + 1):
        uc = su.upd_cols(dom, uc, cubic_rev, i)
    ut = contravariant(uc, v, cosa_u, rsin_u)
    edge4 = _edge_interpolate4_x(ua, dxa)
    sinw = torch.where(edge4 > 0.0, sh(sin_sg3, -1), sin_sg1)
    for i in (h, h + n):
        ut = su.upd_cols(dom, ut, edge4, i)
        uc = su.upd_cols(dom, uc, (edge4 * sinw), i)

    # y-direction corner fills
    vtmp = _fill_cells(vtmp, utmp, dom, "y", 3)
    va = _fill_cells(va, ua, dom, "y", 2)

    # A -> C on y-interfaces
    vc = A2 * (sh(vtmp, 0, -2) + sh(vtmp, 0, 1)) \
        + A1 * (sh(vtmp, 0, -1) + vtmp)
    cubic = C1 * sh(vtmp, 0, -2) + C2 * sh(vtmp, 0, -1) + C3 * vtmp
    cubic_rev = C1 * sh(vtmp, 0, 1) + C2 * vtmp + C3 * sh(vtmp, 0, -1)
    for j in (h - 1, h + n - 1):
        vc = su.upd_rows(dom, vc, cubic, j)
    for j in (h + 1, h + n + 1):
        vc = su.upd_rows(dom, vc, cubic_rev, j)
    vt = contravariant(vc, u, cosa_v, rsin_v)
    edge4 = _edge_interpolate4_y(va, dya)
    sins = torch.where(edge4 > 0.0, sh(sin_sg4, 0, -1), sin_sg2)
    for j in (h, h + n):
        vt = su.upd_rows(dom, vt, edge4, j)
        vc = su.upd_rows(dom, vc, (edge4 * sins), j)

    return uc, vc, ua, va, ut, vt


def _fill_cells(q, q_corner, dom, direction, ncells):
    """Corner fill with the rotated companion component (sign -1 at the
    south-west and north-east corners)."""
    return corner_ops.fill_corners_cells(
        q, q_corner, dom, direction, ncells,
        sw_mult=-1.0, se_mult=1.0, nw_mult=1.0, ne_mult=-1.0,
    )

