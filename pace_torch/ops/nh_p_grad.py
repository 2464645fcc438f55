"""Nonhydrostatic horizontal pressure-gradient force + small halo fills.

Port of `pace_tpu.ops.nh_p_grad` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/nh_p_grad.py
(`NonHydrostaticPressureGradient`), pe_halo.py (`edge_pe`), pk3_halo.py
(`PK3Halo`), ray_fast.py (`RayleighDamping`) and temperature_adjust.py
(`apply_diffusive_heating`).
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.ops import stencil_utils as su
from pace_torch.ops.a2b_ord4 import a2b_ord4
from pace_torch.ops.riemann import interfaces
from pace_torch.ops.stencil_utils import shift, sign
from pace_torch.utils import constants

SDAY = 86400.0


def nh_p_grad(u, v, pp, gz, pk3, delp, gd, dom, dt, ptop, akap):
    """Apply hydrostatic + nonhydrostatic PGF to (u*dx, v*dy), returning
    true winds. pp/gz/pk3 are interface fields (..., nz+1); returns
    (u, v, pp_b, gz_b, pk3_b)."""
    # interpolate to cell corners; pp and pk3 skip k=0 (set explicitly
    # below).  a2b_ord4 is level-independent, so all four fields ride ONE
    # call concatenated along k — the corner/edge handling and metric
    # broadcasts are materialized once instead of four times.
    nzp = gz.shape[-1]
    nz = nzp - 1
    stacked = torch.cat([pp[..., 1:], pk3[..., 1:], gz, delp], -1)
    out = a2b_ord4(stacked, gd, dom)
    pp = torch.cat([pp[..., :1], out[..., :nz]], -1)
    pk3 = torch.cat([pk3[..., :1], out[..., nz:2 * nz]], -1)
    gz = out[..., 2 * nz:2 * nz + nzp]
    wk1 = out[..., 2 * nz + nzp:]

    top_value = ptop ** akap
    pp = su.upd_k(pp, torch.zeros_like(pp), 0)
    pk3 = su.upd_k(pk3, torch.full_like(pk3, top_value), 0)
    wk = pk3[..., 1:] - pk3[..., :-1]

    rdx = gd.horizontal.rdx[..., None]
    rdy = gd.horizontal.rdy[..., None]

    du = dt / (wk + shift(wk, 1)) * (
        (gz[..., 1:] - shift(gz, 1)[..., :-1])
        * (shift(pk3, 1)[..., 1:] - pk3[..., :-1])
        + (gz[..., :-1] - shift(gz, 1)[..., 1:])
        * (pk3[..., 1:] - shift(pk3, 1)[..., :-1])
    )
    u = (
        u + du + dt / (wk1 + shift(wk1, 1)) * (
            (gz[..., 1:] - shift(gz, 1)[..., :-1])
            * (shift(pp, 1)[..., 1:] - pp[..., :-1])
            + (gz[..., :-1] - shift(gz, 1)[..., 1:])
            * (pp[..., 1:] - shift(pp, 1)[..., :-1])
        )
    ) * rdx

    dv = dt / (wk + shift(wk, 0, 1)) * (
        (gz[..., 1:] - shift(gz, 0, 1)[..., :-1])
        * (shift(pk3, 0, 1)[..., 1:] - pk3[..., :-1])
        + (gz[..., :-1] - shift(gz, 0, 1)[..., 1:])
        * (pk3[..., 1:] - shift(pk3, 0, 1)[..., :-1])
    )
    v = (
        v + dv + dt / (wk1 + shift(wk1, 0, 1)) * (
            (gz[..., 1:] - shift(gz, 0, 1)[..., :-1])
            * (shift(pp, 0, 1)[..., 1:] - pp[..., :-1])
            + (gz[..., :-1] - shift(gz, 0, 1)[..., 1:])
            * (pp[..., 1:] - shift(pp, 0, 1)[..., :-1])
        )
    ) * rdy
    return u, v, pp, gz, pk3


def pe_halo(pe, delp, ptop, dom):
    """Recompute interface pressure on the 1-deep halo ring
    (pe_halo.py edge_pe)."""
    n, h = dom.n, dom.h
    pe_new = interfaces(ptop, delp)
    out = pe
    for i in (h - 1, h + n):
        out = su.upd_point(dom, out, pe_new, i, slice(h, h + n))
    for j in (h - 1, h + n):
        out = su.upd_point(dom, out, pe_new, slice(h - 1, h + n + 1), j)
    return out


def pk3_halo(pk3, delp, ptop, akap, dom):
    """Recompute pk3 = pe**kappa on the 2-deep halo ring (pk3_halo.py)."""
    n, h = dom.n, dom.h
    # the reference leaves the k=0 interface untouched on the ring
    pk3_new = torch.cat([pk3[..., :1],
                         interfaces(ptop, delp)[..., 1:] ** akap], -1)
    out = pk3
    for i in (h - 2, h - 1, h + n, h + n + 1):
        out = su.upd_point(dom, out, pk3_new, i, slice(h, h + n))
    for j in (h - 2, h - 1, h + n, h + n + 1):
        out = su.upd_point(dom, out, pk3_new, slice(h - 2, h + n + 2), j)
    return out


def ray_fast(u, v, w, dp_ref, pfull, dt, ptop, rf_cutoff, tau, hydrostatic):
    """Rayleigh sponge-layer friction above rf_cutoff (ray_fast.py); a
    hydrostatic model's w is left alone.

    dp_ref/pfull: (nz,) numpy columns. Returns (u, v, w)."""
    dp_ref = np.asarray(dp_ref)
    pfull = np.asarray(pfull)
    rf_cutoff_nudge = rf_cutoff + min(100.0, 10.0 * ptop)
    mask_c = pfull < rf_cutoff
    mask_n = pfull < rf_cutoff_nudge
    rf_vals = (
        dt / (tau * SDAY)
        * np.sin(
            0.5 * constants.PI * np.log(rf_cutoff / np.where(mask_c, pfull, rf_cutoff))
            / np.log(rf_cutoff / ptop)
        ) ** 2
    )
    rf = np.where(mask_c, 1.0 / (1.0 + rf_vals), 1.0)
    p_ref_total = float((dp_ref * mask_n).sum())

    rf_j = su.column(rf, u)
    mc = su.level_mask(mask_c, u)
    mn = su.level_mask(mask_n, u)
    dpr = su.column(dp_ref, u)

    dm_u = torch.where(mc, (1.0 - rf_j) * dpr * u, 0.0).sum(-1, keepdim=True)
    u = torch.where(mc, u * rf_j, u)
    u = torch.where(mn, u + dm_u / p_ref_total, u)
    dm_v = torch.where(mc, (1.0 - rf_j) * dpr * v, 0.0).sum(-1, keepdim=True)
    v = torch.where(mc, v * rf_j, v)
    v = torch.where(mn, v + dm_v / p_ref_total, v)
    if not hydrostatic:
        w = torch.where(mc, w * rf_j, w)
    return u, v, w


def apply_diffusive_heating(delp, delz, cappa, heat_source, pt, delt_time_factor):
    """Temperature adjustment from vorticity-damping heating
    (temperature_adjust.py), with per-level increment limiting."""
    pkz = (constants.RDG * delp / delz * pt) ** (cappa / (1.0 - cappa))
    dtmp = heat_source / (constants.CV_AIR * delp)
    nz = pt.shape[-1]
    limit = np.full(nz, delt_time_factor)
    limit[0] = delt_time_factor * 0.1
    if nz > 1:
        limit[1] = delt_time_factor * 0.5
    lim = su.column(limit, pt)
    deltmin = sign(torch.minimum(lim, torch.abs(dtmp)), dtmp)
    return pt + deltmin / pkz
