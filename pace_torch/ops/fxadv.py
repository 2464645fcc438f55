"""Finite-volume flux preparation (fxadv): contravariant C-grid winds,
courant numbers and area fluxes for the D-grid transport.

Port of `pace_tpu.ops.fxadv` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/fxadv.py `FiniteVolumeFluxPrep`), including
the 2x2 corner system solves that make edge-parallel contravariant winds
consistent with the facing panel.
"""

from __future__ import annotations

import torch

from pace_torch.ops import stencil_utils as su
from pace_torch.ops.d2a2c import contravariant
from pace_torch.ops.stencil_utils import shift


def fx_adv(uc, vc, ut_in, vt_in, gd, dom, dt):
    """Returns (crx, cry, x_area_flux, y_area_flux, ut, vt) where ut/vt are
    the contravariant C-grid winds (uc_contra/vc_contra)."""
    n, h = dom.n, dom.h
    ang, hz = gd.angle, gd.horizontal
    cosa_u = ang.cosa_u[..., None]
    rsin_u = ang.rsin_u[..., None]
    cosa_v = ang.cosa_v[..., None]
    rsin_v = ang.rsin_v[..., None]
    sin1 = ang.sin_sg[..., 0][..., None]
    sin2 = ang.sin_sg[..., 1][..., None]
    sin3 = ang.sin_sg[..., 2][..., None]
    sin4 = ang.sin_sg[..., 3][..., None]

    # --- main contravariant conversion -------------------------------------
    v_at_u = 0.25 * (shift(vc, -1) + vc + shift(vc, -1, 1) + shift(vc, 0, 1))
    ut = contravariant(uc, v_at_u, cosa_u, rsin_u)
    # restore incoming values on the rows adjacent to south/north tile edges
    for j in (h - 1, h, h + n - 1, h + n):
        ut = su.upd_rows(dom, ut, ut_in, j)
    u_at_v = 0.25 * (shift(uc, 0, -1) + shift(uc, 1, -1) + uc + shift(uc, 1))
    vt = contravariant(vc, u_at_v, cosa_v, rsin_v)

    # --- edge treatments -----------------------------------------------------
    # uc y-edges (west/east interface columns)
    edge = torch.where(uc > 0.0, uc / shift(sin3, -1), uc / sin1)
    for i in (h, h + n):
        ut = su.upd_cols(dom, ut, edge, i)
    # vc near west/east edges, excluding rows near south/north edges
    vt_snapshot = vt
    u_contra_avg = 0.25 * (
        shift(ut, 0, -1) + shift(ut, 1, -1) + ut + shift(ut, 1)
    )
    vt_edge = contravariant(vc, u_contra_avg, cosa_v, 1.0)
    for i in (h - 1, h, h + n - 1, h + n):
        vt = su.upd_point(dom, vt, vt_edge, i, slice(h, h + n + 1))
        for j in (h, h + 1, h + n - 1, h + n):
            vt = su.upd_point(dom, vt, vt_snapshot, i, j)
    # vc x-edges (south/north interface rows)
    edge = torch.where(vc > 0.0, vc / shift(sin4, 0, -1), vc / sin2)
    for j in (h, h + n):
        vt = su.upd_rows(dom, vt, edge, j)
    # uc near south/north edges
    ut_snapshot = ut
    v_contra_avg = 0.25 * (
        shift(vt, -1) + vt + shift(vt, -1, 1) + shift(vt, 0, 1)
    )
    ut_edge = contravariant(uc, v_contra_avg, cosa_u, 1.0)
    for j in (h - 1, h, h + n - 1, h + n):
        ut = su.upd_point(dom, ut, ut_edge, slice(h, h + n + 1), j)
        for i in (h, h + 1, h + n - 1, h + n):
            ut = su.upd_point(dom, ut, ut_snapshot, i, j)

    # --- corner 2x2 system solves -------------------------------------------
    ut_c = ut  # snapshot read by the corner formulas
    vt_c = vt

    def setc(arr, expr, points):
        for (ci, cj) in points:
            arr = su.upd_point(dom, arr, expr, ci, cj)
        return arr

    damp = 1.0 / (1.0 - 0.0625 * cosa_u * shift(cosa_v, -1))
    expr = (
        uc - 0.25 * cosa_u * (
            shift(vt_c, -1, 1) + shift(vt_c, 0, 1) + vt_c + shift(vc, -1)
            - 0.25 * shift(cosa_v, -1) * (
                shift(ut_c, -1) + shift(ut_c, -1, -1) + shift(ut_c, 0, -1)
            )
        )
    ) * damp
    ut = setc(ut, expr, [(h + 1, h - 1), (h + 1, h + n - 1)])
    damp = 1.0 / (1.0 - 0.0625 * cosa_u * shift(cosa_v, -1, 1))
    expr = (
        uc - 0.25 * cosa_u * (
            shift(vt_c, -1) + vt_c + shift(vt_c, 0, 1) + shift(vc, -1, 1)
            - 0.25 * shift(cosa_v, -1, 1) * (
                shift(ut_c, -1) + shift(ut_c, -1, 1) + shift(ut_c, 0, 1)
            )
        )
    ) * damp
    ut = setc(ut, expr, [(h + 1, h), (h + 1, h + n)])
    damp = 1.0 / (1.0 - 0.0625 * cosa_u * cosa_v)
    expr = (
        uc - 0.25 * cosa_u * (
            shift(vt_c, 0, 1) + shift(vt_c, -1, 1) + shift(vt_c, -1) + vc
            - 0.25 * cosa_v * (
                shift(ut_c, 1) + shift(ut_c, 1, -1) + shift(ut_c, 0, -1)
            )
        )
    ) * damp
    ut = setc(ut, expr, [(h + n - 1, h - 1), (h + n - 1, h + n - 1)])
    damp = 1.0 / (1.0 - 0.0625 * cosa_u * shift(cosa_v, 0, 1))
    expr = (
        uc - 0.25 * cosa_u * (
            vt_c + shift(vt_c, -1) + shift(vt_c, -1, 1) + shift(vc, 0, 1)
            - 0.25 * shift(cosa_v, 0, 1) * (
                shift(ut_c, 1) + shift(ut_c, 1, 1) + shift(ut_c, 0, 1)
            )
        )
    ) * damp
    ut = setc(ut, expr, [(h + n - 1, h), (h + n - 1, h + n)])

    ut_c2 = ut
    vt_c2 = vt
    damp = 1.0 / (1.0 - 0.0625 * shift(cosa_u, 0, -1) * cosa_v)
    expr = (
        vc - 0.25 * cosa_v * (
            shift(ut_c2, 1, -1) + shift(ut_c2, 1) + ut_c2 + shift(uc, 0, -1)
            - 0.25 * shift(cosa_u, 0, -1) * (
                shift(vt_c2, 0, -1) + shift(vt_c2, -1, -1) + shift(vt_c2, -1)
            )
        )
    ) * damp
    vt = setc(vt, expr, [(h - 1, h + 1), (h + n - 1, h + 1)])
    damp = 1.0 / (1.0 - 0.0625 * shift(cosa_u, 1, -1) * cosa_v)
    expr = (
        vc - 0.25 * cosa_v * (
            shift(ut_c2, 0, -1) + ut_c2 + shift(ut_c2, 1) + shift(uc, 1, -1)
            - 0.25 * shift(cosa_u, 1, -1) * (
                shift(vt_c2, 0, -1) + shift(vt_c2, 1, -1) + shift(vt_c2, 1)
            )
        )
    ) * damp
    vt = setc(vt, expr, [(h, h + 1), (h + n, h + 1)])
    damp = 1.0 / (1.0 - 0.0625 * shift(cosa_u, 1) * cosa_v)
    expr = (
        vc - 0.25 * cosa_v * (
            ut_c2 + shift(ut_c2, 0, -1) + shift(ut_c2, 1, -1) + shift(uc, 1)
            - 0.25 * shift(cosa_u, 1) * (
                shift(vt_c2, 0, 1) + shift(vt_c2, 1, 1) + shift(vt_c2, 1)
            )
        )
    ) * damp
    vt = setc(vt, expr, [(h + n, h + n - 1), (h, h + n - 1)])
    damp = 1.0 / (1.0 - 0.0625 * cosa_u * cosa_v)
    expr = (
        vc - 0.25 * cosa_v * (
            shift(ut_c2, 1) + shift(ut_c2, 1, -1) + shift(ut_c2, 0, -1) + uc
            - 0.25 * cosa_u * (
                shift(vt_c2, 0, 1) + shift(vt_c2, -1, 1) + shift(vt_c2, -1)
            )
        )
    ) * damp
    vt = setc(vt, expr, [(h + n - 1, h + n - 1), (h - 1, h + n - 1)])

    # --- courant numbers and area fluxes -------------------------------------
    rdxa = hz.rdxa[..., None]
    rdya = hz.rdya[..., None]
    dx = hz.dx[..., None]
    dy = hz.dy[..., None]
    crx = torch.where(ut > 0.0, dt * ut * shift(rdxa, -1), dt * ut * rdxa)
    xaf = torch.where(
        ut > 0.0, dy * dt * ut * shift(sin3, -1), dy * dt * ut * sin1
    )
    cry = torch.where(vt > 0.0, dt * vt * shift(rdya, 0, -1), dt * vt * rdya)
    yaf = torch.where(
        vt > 0.0, dx * dt * vt * shift(sin4, 0, -1), dx * dt * vt * sin2
    )
    return crx, cry, xaf, yaf, ut, vt
