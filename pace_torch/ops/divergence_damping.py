"""Divergence damping on cell corners (d_sw's DivergenceDamping).

Port of `pace_tpu.ops.divergence_damping` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/divergence_damping.py):
background 2nd-order damping in the top sponge levels plus nord-order
hyperdiffusion of the corner divergence below, with Smagorinsky-like
flow-dependent enhancement.  Vertical-range specialization
(restrict_vertical / varied-bounds stencils) becomes static k-slicing.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops import stencil_utils as su
from pace_torch.ops.a2b_ord4 import a2b_ord4
from pace_torch.ops.d2a2c import contravariant
from pace_torch.ops.stencil_utils import shift


def _damp_tmp(q, da_min_c, d2_bg, dddmp):
    mintmp = torch.clamp(dddmp * torch.abs(q), max=0.2)
    return da_min_c * torch.maximum(d2_bg, mintmp)


def divergence_damping(
    u, v, va, ua, divg_d, vc, uc, ke, rel_vort_agrid, gd, dom, dt,
    dddmp, d4_bg, nord: int, nord_col, d2_bg_col, stretched_grid=False,
):
    """Returns (vort_damped_bgrid, ke, delpc, divg_d)."""
    n, h = dom.n, dom.h
    ang, hz, dc = gd.angle, gd.horizontal, gd.damping
    da_min = dc.da_min
    da_min_c = dc.da_min_c
    nord_np = np.asarray(nord_col)
    nz = u.shape[-1]
    nonzero_nord = int(nord)
    nonzero_nord_k = 0
    for k in range(len(nord_np)):
        if nord_np[k] > 0:
            nonzero_nord_k = k
            nonzero_nord = int(nord_np[k])
            break
    kstart = nonzero_nord_k
    do_zero_order = nonzero_nord_k > 0
    high_mask = su.level_mask(np.arange(nz) >= kstart, u)
    low_mask = torch.logical_not(high_mask)
    d2_bg = su.column(d2_bg_col, u)

    sin1 = ang.sin_sg[..., 0][..., None]
    sin2 = ang.sin_sg[..., 1][..., None]
    sin3 = ang.sin_sg[..., 2][..., None]
    sin4 = ang.sin_sg[..., 3][..., None]
    rarea_c = hz.rarea_c[..., None]

    delpc = torch.zeros_like(divg_d)
    vort = torch.zeros_like(divg_d)
    if do_zero_order:
        # 2nd-order damping in the sponge levels
        vc_from_va = 0.5 * (shift(va, 0, -1) + va)
        u_contra = contravariant(
            u, vc_from_va, ang.cosa_v[..., None], ang.sina_v[..., None]
        )
        edge = torch.where(vc > 0.0, u * shift(sin4, 0, -1), u * sin2)
        for j in (h, h + n):
            u_contra = su.upd_rows(dom, u_contra, edge, j)
        u_contra_dyc = u_contra * hz.dyc[..., None]

        uc_from_ua = 0.5 * (shift(ua, -1) + ua)
        v_contra = contravariant(
            v, uc_from_ua, ang.cosa_u[..., None], ang.sina_u[..., None]
        )
        edge = torch.where(uc > 0.0, v * shift(sin3, -1), v * sin1)
        for i in (h, h + n):
            v_contra = su.upd_cols(dom, v_contra, edge, i)
        v_contra_dxc = v_contra * hz.dxc[..., None]

        delpc = (
            shift(v_contra_dxc, 0, -1) - v_contra_dxc
            + shift(u_contra_dyc, -1) - u_contra_dyc
        )
        minus = delpc - shift(v_contra_dxc, 0, -1)
        for ci, cj in ((h, h), (h + n, h)):
            delpc = su.upd_point(dom, delpc, minus, ci, cj)
        plus = delpc + v_contra_dxc
        for ci, cj in ((h, h + n), (h + n, h + n)):
            delpc = su.upd_point(dom, delpc, plus, ci, cj)
        delpc = rarea_c * delpc

        damp = _damp_tmp(delpc * dt, da_min_c, d2_bg, dddmp)
        vort_low = damp * delpc
        vort = torch.where(low_mask, vort_low, vort)
        ke = torch.where(low_mask, ke + vort_low, ke)

    # high-k: delpc is the (original) corner divergence
    delpc = torch.where(high_mask, divg_d, delpc)

    divg_u = dc.divg_u[..., None]
    divg_v = dc.divg_v[..., None]
    # float32 range: the damping coefficient dd8 = (da_min_c*d4_bg)**(nord+1)
    # reaches ~1e44 at coarse resolution while the raw hyperdiffusion iterate
    # shrinks like rarea_c**nord ~ 1e-36 — both outside float32.  Fold one
    # factor s = da_min_c*d4_bg (~1e10, f32-safe) into each sweep so every
    # intermediate stays in range; the final product is identical.  The
    # returned divg_d carries the same scaling, which is safe: it is
    # recomputed from scratch by c_sw before its next use.
    # stretched: dd8 = da_min * d4_bg**(nord+1); else (da_min_c*d4_bg)**(nord+1)
    s_damp = d4_bg if stretched_grid else da_min_c * d4_bg
    s_final = da_min * d4_bg if stretched_grid else da_min_c * d4_bg
    for it in range(nonzero_nord):
        fillc = (it + 1) != nonzero_nord
        if fillc:
            fixed = corner_ops.fill_corners_2d(divg_d, dom, "B", "x")
            divg_d = torch.where(high_mask, fixed, divg_d)
        vc_i = (shift(divg_d, 1) - divg_d) * divg_u
        if fillc:
            fixed = corner_ops.fill_corners_2d(divg_d, dom, "B", "y")
            divg_d = torch.where(high_mask, fixed, divg_d)
        uc_i = (shift(divg_d, 0, 1) - divg_d) * divg_v
        if fillc:
            vc_f, uc_f = corner_ops.fill_corners_dgrid(
                vc_i, uc_i, dom, vector=True
            )
            vc_i = torch.where(high_mask, vc_f, vc_i)
            uc_i = torch.where(high_mask, uc_f, uc_i)
        new_divg = shift(uc_i, 0, -1) - uc_i + shift(vc_i, -1) - vc_i
        minus = new_divg - shift(uc_i, 0, -1)
        for ci, cj in ((h, h), (h + n, h)):
            new_divg = su.upd_point(dom, new_divg, minus, ci, cj)
        plus = new_divg + uc_i
        for ci, cj in ((h, h + n), (h + n, h + n)):
            new_divg = su.upd_point(dom, new_divg, plus, ci, cj)
        if not stretched_grid:
            new_divg = new_divg * rarea_c
        divg_d = torch.where(high_mask, new_divg * s_damp, divg_d)

    if dddmp < 1e-5:
        vort = torch.where(high_mask, 0.0, vort)
    else:
        # Smagorinsky: corner-interpolated relative vorticity
        vort_b = a2b_ord4(rel_vort_agrid, gd, dom)
        smag = abs(dt) * torch.sqrt(delpc ** 2 + vort_b ** 2)
        vort = torch.where(high_mask, smag, vort)

    # the nord sweeps already applied s_damp**nord; one more factor completes
    # dd8
    damp = _damp_tmp(vort, da_min_c, d2_bg, dddmp)
    vort_high = damp * delpc + s_final * divg_d
    vort = torch.where(high_mask, vort_high, vort)
    ke = torch.where(high_mask, ke + vort_high, ke)

    return vort, ke, delpc, divg_d
