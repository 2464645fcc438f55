"""D-grid shallow-water Lagrangian dynamics (d_sw) — the D-grid full step.

Port of `pace_tpu.ops.d_sw` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/d_sw.py
`DGridShallowWaterLagrangianDynamics.__call__` :935-1237), preserving the
operation order: flux prep -> delp/w/q_con/pt transport -> kinetic energy
-> divergence damping -> vorticity transport -> wind update -> vorticity
damping & heat source.  Fields sharing a PPM order go through one batched
transport call (the CUDA kernel on the card).
"""

from __future__ import annotations

import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops import delnflux as delnflux_mod
from pace_torch.ops import stencil_utils as su
from pace_torch.ops.d2a2c import contravariant
from pace_torch.ops.divergence_damping import divergence_damping
from pace_torch.ops.fvtp2d import transport_batched
from pace_torch.ops.fxadv import fx_adv
from pace_torch.ops.stencil_utils import shift
from pace_torch.ops.xtp import advect_u_along_x, advect_v_along_y

DCON_THRESHOLD = 1e-5


def flux_increment(gx, gy, rarea):
    return (gx - shift(gx, 1) + gy - shift(gy, 0, 1)) * rarea


def _interpolate_uc_vc_to_corners(uc, vc, ut, vt, gd, dom):
    """Covariant C-grid -> contravariant B-grid (corner) winds
    (d_sw.py interpolate_uc_vc_to_cell_corners)."""
    n, h = dom.n, dom.h
    cosa = gd.angle.cosa[..., None]
    rsina = gd.angle.rsina[..., None]
    ub_cov = 0.5 * (shift(uc, 0, -1) + uc)
    vb_cov = 0.5 * (shift(vc, -1) + vc)
    ub_contra = contravariant(ub_cov, vb_cov, cosa, rsina)
    vb_contra = contravariant(vb_cov, ub_cov, cosa, rsina)
    ub_edge_j = 0.25 * (
        -shift(ut, 0, -2) + 3.0 * (shift(ut, 0, -1) + ut) - shift(ut, 0, 1)
    )
    for j in (h, h + n):
        ub_contra = su.upd_rows(dom, ub_contra, ub_edge_j, j)
    ub_edge_i = 0.5 * (shift(ut, 0, -1) + ut)
    for i in (h, h + n):
        ub_contra = su.upd_cols(dom, ub_contra, ub_edge_i, i)
    vb_edge_i = 0.25 * (
        -shift(vt, -2) + 3.0 * (shift(vt, -1) + vt) - shift(vt, 1)
    )
    for i in (h, h + n):
        vb_contra = su.upd_cols(dom, vb_contra, vb_edge_i, i)
    vb_edge_j = 0.5 * (shift(vt, -1) + vt)
    for j in (h, h + n):
        vb_contra = su.upd_rows(dom, vb_contra, vb_edge_j, j)
    return ub_contra, vb_contra


def _corner_ke(ke, u, v, ut, vt, dt, dom):
    """Cube-corner kinetic-energy special cases (d_sw.py all_corners_ke)."""
    n, h = dom.n, dom.h
    dt6 = dt / 6.0

    def expr(io1, jo1, io2, vsign):
        return dt6 * (
            (ut + shift(ut, 0, -1)) * ((io1 + 1) * u - io1 * shift(u, -1))
            + (vt + shift(vt, -1)) * ((jo1 + 1) * v - jo1 * shift(v, 0, -1))
            + (
                ((jo1 + 1) * ut - jo1 * shift(ut, 0, -1))
                + vsign * ((io1 + 1) * vt - io1 * shift(vt, -1))
            ) * ((io2 + 1) * u - io2 * shift(u, -1))
        )

    for (ci, cj, io1, jo1, io2, vsign) in (
        (h, h, 0, 0, -1, 1),
        (h + n, h, -1, 0, 0, -1),
        (h + n, h + n, -1, -1, 0, 1),
        (h, h + n, 0, -1, -1, -1),
    ):
        e = expr(io1, jo1, io2, vsign)
        ke = su.upd_point(dom, ke, e, ci, cj)
    return ke


def _make_transport(crx, cry, xfx, yfx, gd, dom):
    """Transport closure: the listed fields go through ONE batched
    transport call; the del-n damping stays in torch on the x corner copy.
    Returns (list of (fx, fy), list of q_x)."""
    hz = gd.horizontal

    def transport(qs, hord, xmf=None, ymf=None):
        qy = torch.stack([corner_ops.copy_corners(q, dom, "y") for q in qs])
        qx = corner_ops.copy_corners(qy.movedim(0, -1), dom, "x")
        qx = qx.movedim(-1, 0).contiguous()
        fx, fy = transport_batched(
            qy, qx, crx, cry, xfx, yfx,
            xfx if xmf is None else xmf, yfx if ymf is None else ymf,
            hz.dxa, hz.dya, hz.area, dom, hord,
        )
        return [(fx[i], fy[i]) for i in range(len(qs))], list(qx)

    return transport


def d_sw(
    delp, pt, u, v, w, uc, vc, ua, va, divgd, mfx, mfy, cx, cy,
    q_con, heat_source, diss_est, ut_in, vt_in, gd, col, config, dom, dt,
):
    """One D-grid shallow water step. Returns a dict of updated fields."""
    n, h = dom.n, dom.h
    hz, ang = gd.horizontal, gd.angle
    rarea = hz.rarea[..., None]
    dx = hz.dx[..., None]
    dy = hz.dy[..., None]
    ci = slice(h, h + n)
    cie = slice(h, h + n + 1)

    crx, cry, xfx, yfx, ut, vt = fx_adv(uc, vc, ut_in, vt_in, gd, dom, dt)
    transport = _make_transport(crx, cry, xfx, yfx, gd, dom)

    # cell-mean relative vorticity (Stokes) — from the INPUT u/v; used
    # for the vorticity-flux transport and the damping/heating blocks
    rdy_tmp = rarea * dx
    rdx_tmp = rarea * dy
    vorticity_agrid = (
        u - shift(u, 0, 1) * shift(dx, 0, 1) / dx
    ) * rdy_tmp + (shift(v, 1) * shift(dy, 1) / dy - v) * rdx_tmp
    abs_vorticity = vorticity_agrid + hz.f0[..., None]

    (fluxes, qx_list) = transport([delp], config.hord_dp)
    fx, fy = fluxes[0]
    qx_delp = qx_list[0]
    fx, fy = delnflux_mod.deln_flux(
        qx_delp, fx, fy, gd, col["nord_v"], col["damp_vt"], dom,
    )

    cx = cx + crx
    cy = cy + cry
    mfx = mfx + fx
    mfy = mfy + fy

    # vertical-wind damping fluxes and implied heating
    damp_w_col = delnflux_mod.calc_damp(
        col["damp_w"], gd.damping.da_min_c, col["nord_w"]
    )
    fx2, fy2, _ = delnflux_mod.deln_flux_nosg(
        w, gd.damping.del6_u, gd.damping.del6_v, hz.rarea,
        col["nord_w"], damp_w_col, dom,
    )
    damp_w_mask = su.level_mask(col["damp_w"] > 1e-5, w)
    ke_bg_k = su.column(col["ke_bg"], w)
    dd8 = ke_bg_k * abs(dt)
    dw = torch.where(
        damp_w_mask, (fx2 - shift(fx2, 1) + fy2 - shift(fy2, 0, 1)) * rarea, 0.0
    )
    heat_s = torch.where(damp_w_mask, dd8 - dw * (w + 0.5 * dw), 0.0)
    diss_est = torch.where(damp_w_mask, heat_s, 0.0)

    # w, q_con, and pt transport (mass fluxes from the delp transport);
    # same-hord fields go through one batched transport call
    fields = [("w", w, config.hord_vt, None, None),
              ("q_con", q_con, config.hord_dp, col["nord_t"],
               col["damp_t"]),
              ("pt", pt, config.hord_tm, col["nord_v"], col["damp_vt"])]
    results = {}
    by_hord = {}
    for name, q, hord, nord_c, damp_c in fields:
        by_hord.setdefault(hord, []).append((name, q, nord_c, damp_c))
    for hord, group in by_hord.items():
        fluxes, qx_list = transport([g[1] for g in group], hord,
                                    xmf=fx, ymf=fy)
        for (name, q, nord_c, damp_c), (gx, gy), qx in zip(
                group, fluxes, qx_list):
            if nord_c is not None:
                gx, gy = delnflux_mod.deln_flux(
                    qx, gx, gy, gd, nord_c, damp_c, dom, mass=delp,
                )
            results[name] = (gx, gy)

    gx, gy = results["w"]
    w = w * delp + flux_increment(gx, gy, rarea)
    gx, gy = results["q_con"]
    q_con = q_con * delp + flux_increment(gx, gy, rarea)

    # pt transport and the delp update (compute domain only)
    gx, gy = results["pt"]
    pt_new = pt * delp + flux_increment(gx, gy, rarea)
    delp_new = delp + flux_increment(fx, fy, rarea)
    pt_new = pt_new / delp_new
    pt = su.upd_point(dom, pt, pt_new, ci, ci)
    delp = su.upd_point(dom, delp, delp_new, ci, ci)

    # finish w/q_con updates
    w = w / delp
    w = torch.where(damp_w_mask, w + dw, w)
    q_con = q_con / delp

    # kinetic energy on corners (Hollingsworth-Kallberg-consistent)
    ub_contra, vb_contra = _interpolate_uc_vc_to_corners(
        uc, vc, ut, vt, gd, dom
    )
    advected_v = advect_v_along_y(
        v, vb_contra, hz.rdy[..., None], dy, hz.dya[..., None], dt, dom,
        config.hord_mt,
    )
    advected_u = advect_u_along_x(
        u, ub_contra, hz.rdx[..., None], dx, hz.dxa[..., None], dt, dom,
        config.hord_mt,
    )
    ke = 0.5 * dt * (ub_contra * advected_u + vb_contra * advected_v)
    ke = _corner_ke(ke, u, v, ut, vt, dt, dom)

    vort_damped_b, ke, delpc, divgd = divergence_damping(
        u, v, va, ua, divgd, vc, uc, ke, vorticity_agrid, gd, dom, dt,
        dddmp=config.dddmp, d4_bg=config.d4_bg, nord=config.nord,
        nord_col=col["nord"], d2_bg_col=col["d2_divg"],
    )

    fluxes, _ = transport([abs_vorticity], config.hord_vt)
    fx, fy = fluxes[0]

    # u/v update from KE gradient + vorticity fluxes (outputs u*dx, v*dy)
    u_new = u * dx + ke - shift(ke, 1) + fy
    v_new = v * dy + ke - shift(ke, 0, 1) - fx
    u = su.upd_point(dom, u, u_new, ci, cie)
    v = su.upd_point(dom, v, v_new, cie, ci)

    # vorticity damping fluxes and implied heating
    damp_vt_col = delnflux_mod.calc_damp(
        col["damp_vt"], gd.damping.da_min_c, col["nord_v"]
    )
    ut_d, vt_d, _ = delnflux_mod.deln_flux_nosg(
        vorticity_agrid, gd.damping.del6_u, gd.damping.del6_v, hz.rarea,
        col["nord_v"], damp_vt_col, dom,
    )

    if col["d_con"][0] > DCON_THRESHOLD or config.do_skeb:
        vxd = torch.zeros_like(vort_damped_b)
        vyd = torch.zeros_like(vort_damped_b)
        dcol = vort_damped_b - shift(vort_damped_b, 1)
        vxd = su.upd_point(dom, vxd, dcol, ci, cie)
        dcol = vort_damped_b - shift(vort_damped_b, 0, 1)
        vyd = su.upd_point(dom, vyd, dcol, cie, ci)

        rdx = hz.rdx[..., None]
        rdy = hz.rdy[..., None]
        rsin2 = ang.rsin2[..., None]
        cosa_s = ang.cosa_s[..., None]
        ubt = (vxd + vt_d) * rdx
        fy_h = u * rdx
        gy_h = fy_h * ubt
        vbt = (vyd - ut_d) * rdy
        fx_h = v * rdy
        gx_h = fx_h * vbt
        u2 = fy_h + shift(fy_h, 0, 1)
        du2 = ubt + shift(ubt, 0, 1)
        v2 = fx_h + shift(fx_h, 1)
        dv2 = vbt + shift(vbt, 1)
        dampterm = rsin2 * 0.25 * (
            (ubt * ubt + shift(ubt, 0, 1) * shift(ubt, 0, 1)
             + vbt * vbt + shift(vbt, 1) * shift(vbt, 1))
            + 2.0 * (gy_h + shift(gy_h, 0, 1) + gx_h + shift(gx_h, 1))
            - cosa_s * (u2 * dv2 + v2 * du2 + du2 * dv2)
        )
        d_con_k = su.column(col["d_con"], w)
        heat_mask = d_con_k > DCON_THRESHOLD
        if config.do_skeb:
            heat_s = delp * (heat_s - d_con_k * dampterm)
        else:
            heat_s = torch.where(
                heat_mask, delp * (heat_s - d_con_k * dampterm), heat_s
            )
        heat_source = su.region_add(dom, heat_source, ci, ci, heat_s)
        if config.do_skeb:
            diss_est = diss_est - dampterm

    damp_vt_mask = su.level_mask(col["damp_vt"] > 1e-5, w)
    u_upd = torch.where(damp_vt_mask, u + vt_d, u)
    v_upd = torch.where(damp_vt_mask, v - ut_d, v)
    u = su.upd_point(dom, u, u_upd, ci, cie)
    v = su.upd_point(dom, v, v_upd, cie, ci)

    return dict(
        delp=delp, pt=pt, u=u, v=v, w=w, q_con=q_con, divgd=divgd,
        delpc=delpc, mfx=mfx, mfy=mfy, cx=cx, cy=cy, crx=crx, cry=cry,
        xfx=xfx, yfx=yfx, heat_source=heat_source, diss_est=diss_est,
        ut=ut, vt=vt,
    )
