"""C-grid shallow-water half-step (c_sw).

Port of `pace_tpu.ops.c_sw` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/c_sw.py `CGridShallowWaterDynamics`):
advances C-grid winds (and delp/pt on the C-grid) by half a timestep to
provide advective fluxes for the D-grid step.
"""

from __future__ import annotations

import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops import stencil_utils as su
from pace_torch.ops.d2a2c import d2a2c_vect
from pace_torch.ops.stencil_utils import shift as sh


def _sg(gd, i):
    ang = gd.angle
    return (ang.sin_sg[..., i - 1][..., None],
            ang.cos_sg[..., i - 1][..., None])


def divergence_corner(u, v, ua, va, gd, dom):
    """D-grid divergence at cell corners (for divergence damping)."""
    n, h = dom.n, dom.h
    dxc = gd.horizontal.dxc[..., None]
    dyc = gd.horizontal.dyc[..., None]
    rarea_c = gd.horizontal.rarea_c[..., None]
    sin1, cos1 = _sg(gd, 1)
    sin2, cos2 = _sg(gd, 2)
    sin3, cos3 = _sg(gd, 3)
    sin4, cos4 = _sg(gd, 4)

    uf = (
        (u - 0.25 * (sh(va, 0, -1) + va) * (sh(cos4, 0, -1) + cos2))
        * dyc * 0.5 * (sh(sin4, 0, -1) + sin2)
    )
    vf = (
        (v - 0.25 * (sh(ua, -1) + ua) * (sh(cos3, -1) + cos1))
        * dxc * 0.5 * (sh(sin3, -1) + sin1)
    )
    divg_d = (sh(vf, 0, -1) - vf + sh(uf, -1) - uf) * rarea_c

    # tile-edge variants: on edges the cross terms drop (uf/vf use the raw
    # covariant wind there)
    uf0 = u * dyc * 0.5 * (sh(sin4, 0, -1) + sin2)
    vf0 = v * dxc * 0.5 * (sh(sin3, -1) + sin1)
    # west/east interface columns (i = h, h+n)
    col = (sh(vf0, 0, -1) - vf0 + sh(uf, -1) - uf) * rarea_c
    divg_d = su.upd_cols(dom, divg_d, col, h)
    divg_d = su.upd_cols(dom, divg_d, col, h + n)
    # south/north rows (j = h, h+n)
    row = (sh(vf, 0, -1) - vf + sh(uf0, -1) - uf0) * rarea_c
    divg_d = su.upd_rows(dom, divg_d, row, h)
    divg_d = su.upd_rows(dom, divg_d, row, h + n)
    # corners
    sw = (-vf0 + sh(uf0, -1) - uf0) * rarea_c
    for ci, cj in ((h, h), (h + n, h)):
        divg_d = su.upd_point(dom, divg_d, sw, ci, cj)
    ne = (sh(vf0, 0, -1) + sh(uf0, -1) - uf0) * rarea_c
    for ci, cj in ((h + n, h + n), (h, h + n)):
        divg_d = su.upd_point(dom, divg_d, ne, ci, cj)
    return divg_d


def c_sw_part1(u, v, gd, dom, nord):
    """d2a2c + corner divergence (the deep-reach half of c_sw).
    Returns (uc, vc, ua, va, ut, vt, divgd)."""
    uc, vc, ua, va, ut, vt = d2a2c_vect(u, v, gd, dom)
    if nord > 0:
        divgd = divergence_corner(u, v, ua, va, gd, dom)
    else:
        divgd = torch.zeros_like(u)
    return uc, vc, ua, va, ut, vt, divgd


def c_sw_part2(delp, pt, w, u, v, uc, vc, ua, va, ut, vt, gd, dom, dt2):
    """Transport + ke/vorticity + C-wind update (shallow-reach half).
    Returns (delpc, ptc, uc2, vc2, ut2, vt2, omga, delp_f, pt_f, w_f)."""
    n, h = dom.n, dom.h
    sin1, cos1 = _sg(gd, 1)
    sin2, cos2 = _sg(gd, 2)
    sin3, cos3 = _sg(gd, 3)
    sin4, cos4 = _sg(gd, 4)
    rarea = gd.horizontal.rarea[..., None]
    dx = gd.horizontal.dx[..., None]
    dy = gd.horizontal.dy[..., None]

    # geoadjust: first-order upwind volume fluxes
    ut = torch.where(
        ut > 0.0,
        dt2 * ut * dy * sh(sin3, -1),
        dt2 * ut * dy * sin1,
    )
    vt = torch.where(
        vt > 0.0,
        dt2 * vt * dx * sh(sin4, 0, -1),
        dt2 * vt * dx * sin2,
    )

    # x-direction corner fill + fluxes
    delp = corner_ops.fill_corners_cells(delp, delp, dom, "x", 2)
    pt = corner_ops.fill_corners_cells(pt, pt, dom, "x", 2)
    w = corner_ops.fill_corners_cells(w, w, dom, "x", 2)
    fx1 = torch.where(ut > 0.0, sh(delp, -1), delp)
    fx = torch.where(ut > 0.0, sh(pt, -1), pt)
    fx2 = torch.where(ut > 0.0, sh(w, -1), w)
    fx1 = ut * fx1
    fx = fx1 * fx
    fx2 = fx1 * fx2

    # y-direction corner fill + transport
    delp = corner_ops.fill_corners_cells(delp, delp, dom, "y", 2)
    pt = corner_ops.fill_corners_cells(pt, pt, dom, "y", 2)
    w = corner_ops.fill_corners_cells(w, w, dom, "y", 2)
    fy1 = torch.where(vt > 0.0, sh(delp, 0, -1), delp)
    fy = torch.where(vt > 0.0, sh(pt, 0, -1), pt)
    fy2 = torch.where(vt > 0.0, sh(w, 0, -1), w)
    fy1 = vt * fy1
    fy = fy1 * fy
    fy2 = fy1 * fy2

    delpc = delp + (fx1 - sh(fx1, 1) + fy1 - sh(fy1, 0, 1)) * rarea
    ptc = (pt * delp + (fx - sh(fx, 1) + fy - sh(fy, 0, 1)) * rarea) / delpc
    omga = (w * delp + (fx2 - sh(fx2, 1) + fy2 - sh(fy2, 0, 1)) * rarea) \
        / delpc

    # kinetic energy and vorticity with upstream bias
    ke = torch.where(ua > 0.0, uc, sh(uc, 1))
    vort = torch.where(va > 0.0, vc, sh(vc, 0, 1))
    # tile-edge overrides
    v_edge_lo = torch.where(
        va <= 0.0, vort * sin4 + sh(u, 0, 1) * cos4, vort
    )
    for j in (h - 1, h + n - 1):
        vort = su.upd_rows(dom, vort, v_edge_lo, j)
    v_edge_hi = torch.where(va > 0.0, vort * sin2 + u * cos2, vort)
    for j in (h, h + n):
        vort = su.upd_rows(dom, vort, v_edge_hi, j)
    k_edge_lo = torch.where(ua <= 0.0, ke * sin3 + sh(v, 1) * cos3, ke)
    for i in (h + n - 1, h - 1):
        ke = su.upd_cols(dom, ke, k_edge_lo, i)
    k_edge_hi = torch.where(ua > 0.0, ke * sin1 + v * cos1, ke)
    for i in (h + n, h):
        ke = su.upd_cols(dom, ke, k_edge_hi, i)
    ke = 0.5 * dt2 * (ua * ke + va * vort)

    # C-grid circulation -> absolute vorticity at corners
    vort_c = circulation_cgrid(uc, vc, gd, dom)
    vort_c = gd.horizontal.fC[..., None] + gd.horizontal.rarea_c[..., None] * vort_c

    # update C-grid winds
    uc, vc = vorticity_transport_cgrid(
        uc, vc, vort_c, ke, u, v, gd, dom, dt2
    )

    return delpc, ptc, uc, vc, ut, vt, omga, delp, pt, w


def circulation_cgrid(uc, vc, gd, dom):
    """Raw C-grid circulation at cell corners (reference c_sw.py
    circulation_cgrid:367-408: fx/fy line integrals with the corner
    one-sided variants; absolute vorticity -- fC + rarea_c * this -- is
    applied by the caller)."""
    n, h = dom.n, dom.h
    dxc = gd.horizontal.dxc[..., None]
    dyc = gd.horizontal.dyc[..., None]
    fxc = dxc * uc
    fyc = dyc * vc
    vort_c = sh(fxc, 0, -1) - fxc - sh(fyc, -1) + fyc
    no_fy1 = sh(fxc, 0, -1) - fxc + fyc
    for ci, cj in ((h, h), (h, h + n)):
        vort_c = su.upd_point(dom, vort_c, no_fy1, ci, cj)
    no_fy = sh(fxc, 0, -1) - fxc - sh(fyc, -1)
    for ci, cj in ((h + n, h), (h + n, h + n)):
        vort_c = su.upd_point(dom, vort_c, no_fy, ci, cj)
    return vort_c


def vorticity_transport_cgrid(uc, vc, vort_c, ke, u, v, gd, dom, dt2):
    """C-grid wind update from the absolute-vorticity flux and the KE
    gradient (reference c_sw.py update_x_velocity:411 /
    update_y_velocity:445, called at c_sw.py:758-776).  Returns
    (uc_new, vc_new)."""
    n, h = dom.n, dom.h
    cosa_v = gd.angle.cosa_v[..., None]
    sina_v = gd.angle.sina_v[..., None]
    cosa_u = gd.angle.cosa_u[..., None]
    sina_u = gd.angle.sina_u[..., None]
    rdxc = gd.horizontal.rdxc[..., None]
    rdyc = gd.horizontal.rdyc[..., None]

    tmp_flux = dt2 * (u - vc * cosa_v) / sina_v
    edge = dt2 * u
    for j in (h, h + n):
        tmp_flux = su.upd_rows(dom, tmp_flux, edge, j)
    flux = torch.where(tmp_flux > 0.0, vort_c, sh(vort_c, 1))
    vc = vc - tmp_flux * flux + rdyc * (sh(ke, 0, -1) - ke)

    tmp_flux = dt2 * (v - uc * cosa_u) / sina_u
    edge = dt2 * v
    for i in (h, h + n):
        tmp_flux = su.upd_cols(dom, tmp_flux, edge, i)
    flux = torch.where(tmp_flux > 0.0, vort_c, sh(vort_c, 0, 1))
    uc = uc + tmp_flux * flux + rdxc * (sh(ke, -1) - ke)
    return uc, vc


def c_sw(delp, pt, u, v, w, omga_unused, gd, dom, dt2, nord):
    """C-grid shallow water half step.

    Returns (delpc, ptc, uc, vc, ua, va, ut, vt, divgd, omga,
    delp_f, pt_f, w_f) where *_f are the inputs with cube-corner wedges
    filled (the reference updates them in place).
    """
    uc, vc, ua, va, ut, vt, divgd = c_sw_part1(u, v, gd, dom, nord)
    (delpc, ptc, uc, vc, ut, vt, omga, delp_f, pt_f, w_f) = c_sw_part2(
        delp, pt, w, u, v, uc, vc, ua, va, ut, vt, gd, dom, dt2
    )
    return (delpc, ptc, uc, vc, ua, va, ut, vt, divgd, omga, delp_f,
            pt_f, w_f)
