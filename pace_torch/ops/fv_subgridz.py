"""Dry convective adjustment in the top sponge layers (fv_subgridz).

Port of `pace_tpu.ops.fv_subgridz` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/fv_subgridz.py `DryConvectiveAdjustment`): a
Richardson-number-based 2-layer mixing scheme applied over the top
`n_sponge` levels, iterated m=3 times with mixing ratios 0.25/0.5/0.999,
followed by a relaxation blend and wind-tendency output.

The reference's BACKWARD gt4py computation with per-interval ri_ref
multipliers (m_loop, fv_subgridz.py:236-660) is a Python loop running from
the bottom of the sponge upward, carrying the inter-level mixing fluxes
h0; the interval specializations become per-level Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.ops.stencil_utils import (
    levels,
    maximum,
    minimum,
    reverse_cumsum,
)
from pace_torch.utils import constants as con

RK = con.CP_AIR / con.RDGAS + 1.0
G2 = 0.5 * con.GRAV
T1_MIN = 160.0
T2_MIN = 165.0
T2_MAX = 315.0
T3_MAX = 325.0
USTAR2 = 1.0e-4
RI_MAX = 1.0
RI_MIN = 0.25

TRACERS = ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel",
           "qo3mr", "qsgs_tke", "qcld")
# fields mixed by kh_adjust (tracers + winds); total_energy is mixed via
# the static-energy difference
MIXED = TRACERS + ("u0", "v0", "w0")


def _standard_cm(qv, ql_, qr, qi, qs, qg):
    q_liq = ql_ + qr
    q_sol = qi + qs + qg
    dry = 1.0 - (qv + q_liq + q_sol)
    cpm = dry * con.CP_AIR + qv * con.CP_VAP + q_liq * con.C_LIQ \
        + q_sol * con.C_ICE
    cvm = dry * con.CV_AIR + qv * con.CV_VAP + q_liq * con.C_LIQ \
        + q_sol * con.C_ICE
    return cpm, cvm


def _tvol(gz, u0, v0, w0):
    return gz + 0.5 * (u0 ** 2 + v0 ** 2 + w0 ** 2)


def _adjust_cvm(f):
    cpm, cvm = _standard_cm(f["qvapor"], f["qliquid"], f["qrain"],
                            f["qice"], f["qsnow"], f["qgraupel"])
    tv = _tvol(f["gz"], f["u0"], f["v0"], f["w0"])
    t0 = (f["te"] - tv) / cvm
    f = dict(f, cpm=cpm, cvm=cvm, t0=t0, se=cpm * t0 + tv)
    return f


def _qcon(f):
    return f["qliquid"] + f["qice"] + f["qsnow"] + f["qrain"] + f["qgraupel"]


def dry_convective_adjustment(s: dict, timestep: float, fv_sg_adj: float,
                              n_sponge: int, nwat: int = 6,
                              hydrostatic: bool = False,
                              ptop: float = 100.0):
    """Returns (updated state dict, u_dt, v_dt).  s holds the DycoreState
    arrays (shape (..., nz)).  ptop is static (selects the t_min bound as
    the reference does from pe[0], fv_subgridz.py:866-870)."""
    if hydrostatic:
        raise NotImplementedError("hydrostatic fv_subgridz")
    nz = s["pt"].shape[-1]
    kbot = n_sponge if n_sponge is not None else nz
    zero_dt = torch.zeros_like(s["pt"])
    if kbot < 3:
        return s, zero_dt, zero_dt
    t_max = T2_MAX if kbot < min(nz, 24) else T3_MAX
    xvir = 0.0 if nwat == 0 else con.ZVIR
    t_min = T1_MIN if ptop < 2.0 else T2_MIN

    sl = slice(0, kbot)
    # init (reference fv_subgridz.py:68-129): save working copies and build
    # sponge-relative geopotential
    f = {name: s[name][..., sl] for name in TRACERS}
    f["u0"] = s["ua"][..., sl]
    f["v0"] = s["va"][..., sl]
    f["w0"] = s["w"][..., sl]
    f["t0"] = s["pt"][..., sl]
    delz = s["delz"][..., sl]
    # gzh upward accumulation from the bottom of the sponge
    gzh_below = -con.GRAV * reverse_cumsum(delz)
    gzh = gzh_below + con.GRAV * delz  # gzh[k+1]
    f["gz"] = gzh - G2 * delz
    cpm, cvm = _standard_cm(f["qvapor"], f["qliquid"], f["qrain"],
                            f["qice"], f["qsnow"], f["qgraupel"])
    tv = _tvol(f["gz"], f["u0"], f["v0"], f["w0"])
    f["cpm"], f["cvm"] = cpm, cvm
    f["se"] = cpm * f["t0"] + tv
    f["te"] = cvm * f["t0"] + tv

    delp = s["delp"][..., sl]
    pkz = s["pkz"][..., sl]
    dlogp = s["peln"][..., 1:kbot + 1] - s["peln"][..., :kbot]

    # per-level ri_ref multiplier (reference interval specializations)
    mult = np.ones(kbot)
    if kbot > 1:
        mult[1] = 4.0
    if kbot > 2:
        mult[2] = 2.0
    if kbot > 3:
        mult[3] = 1.5

    state_names = list(TRACERS) + ["u0", "v0", "w0", "t0", "se", "te",
                                   "cpm", "cvm", "gz"]

    for m in range(3):
        ratio = {0: 0.25, 1: 0.5, 2: 0.999}[m]
        f = _m_loop(f, delp, pkz, dlogp, mult, kbot, ratio, xvir, t_max,
                    t_min, state_names)

    # finalize (reference fv_subgridz.py:667-735)
    fra = timestep / float(fv_sg_adj)
    if fra < 1.0:
        for name, src in (
            ("t0", s["pt"]), ("u0", s["ua"]), ("v0", s["va"]),
            ("w0", s["w"]),
        ):
            f[name] = src[..., sl] + (f[name] - src[..., sl]) * fra
        for name in TRACERS:
            f[name] = s[name][..., sl] + (f[name] - s[name][..., sl]) * fra
    rdt = 1.0 / timestep
    pad = torch.zeros_like(s["pt"][..., kbot:])
    u_dt = torch.cat([rdt * (f["u0"] - s["ua"][..., sl]), pad], -1)
    v_dt = torch.cat([rdt * (f["v0"] - s["va"][..., sl]), pad], -1)

    out = dict(s)

    def put(full, part):
        return torch.cat([part, full[..., kbot:]], -1)

    out["pt"] = put(s["pt"], f["t0"])
    out["ua"] = put(s["ua"], f["u0"])
    out["va"] = put(s["va"], f["v0"])
    out["w"] = put(s["w"], f["w0"])
    for name in TRACERS:
        out[name] = put(s[name], f[name])
    return out, u_dt, v_dt


def _m_loop(f, delp, pkz, dlogp, mult, kbot, ratio, xvir, t_max, t_min,
            state_names):
    """One Richardson-mixing sweep from the sponge bottom upward
    (reference m_loop).  The level above each interface enters with its
    values from before the sweep; it is adjusted when its own turn comes."""
    f_l = {n: levels(f[n]) for n in state_names}
    dp_l, pkz_l, dlp_l = levels(delp), levels(pkz), levels(dlogp)

    zeros = torch.zeros_like(dp_l[0])
    h0 = {n: zeros for n in MIXED + ("te",)}
    ri_p, ri_ref_p = zeros, torch.full_like(zeros, RI_MAX + 1.0)
    out = {n: [None] * kbot for n in state_names}

    for k in range(kbot - 1, -1, -1):
        km1 = max(k - 1, 0)
        lev = {n: f_l[n][k] for n in state_names}
        above = {n: f_l[n][km1] for n in state_names}
        dp_k, dp_km1 = dp_l[k], dp_l[km1]

        # "up" adjustment with the flux from the level below
        if k < kbot - 1:
            up = ri_p < ri_ref_p
            for n in MIXED + ("te",):
                lev[n] = torch.where(up, lev[n] + h0[n] / dp_k, lev[n])
        lev = _adjust_cvm(lev)

        # Richardson number across the (k-1, k) interface
        qcon_km1 = _qcon(above)
        qcon_k = _qcon(lev)
        tv1 = above["t0"] * (1.0 + xvir * above["qvapor"] - qcon_km1)
        tv2 = lev["t0"] * (1.0 + xvir * lev["qvapor"] - qcon_k)
        pt1 = tv1 / pkz_l[km1]
        pt2 = tv2 / pkz_l[k]
        ri = (above["gz"] - lev["gz"]) * (pt1 - pt2) / (
            0.5 * (pt1 + pt2)
            * ((above["u0"] - lev["u0"]) ** 2
               + (above["v0"] - lev["v0"]) ** 2 + USTAR2)
        )
        ri = torch.where((tv1 > t_max) & (tv1 > tv2), 0.0,
                         torch.where(tv2 < t_min, minimum(ri, 0.1), ri))
        ri_ref = RI_MIN + (RI_MAX - RI_MIN) * maximum(
            400.0e2 - dp_k / dlp_l[k], 0.0
        ) / 200.0e2
        ri_ref = minimum(ri_ref, RI_MAX) * float(mult[k])

        # mass flux and "down" adjustment
        max_ri_ratio = maximum(ri / ri_ref, 0.0)
        mc = torch.where(
            ri < ri_ref,
            ratio * dp_km1 * dp_k / (dp_km1 + dp_k)
            * (1.0 - max_ri_ratio) ** 2,
            0.0,
        )
        down = (ri < ri_ref) if k > 0 else torch.zeros_like(
            ri, dtype=torch.bool)
        h0 = {}
        for n in MIXED:
            h = mc * (lev[n] - above[n])
            h0[n] = torch.where(down, h, 0.0)
            lev[n] = torch.where(down, lev[n] - h0[n] / dp_k, lev[n])
        h_te = mc * (lev["se"] - above["se"])
        h0["te"] = torch.where(down, h_te, 0.0)
        lev["te"] = torch.where(down, lev["te"] - h0["te"] / dp_k,
                                lev["te"])
        lev = _adjust_cvm(lev)
        for n in state_names:
            out[n][k] = lev[n]
        ri_p, ri_ref_p = ri, ri_ref

    return {n: torch.stack(out[n], -1) for n in state_names}
