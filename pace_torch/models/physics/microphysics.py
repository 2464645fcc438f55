"""GFDL cloud microphysics (six-category, single-moment).

Port of `pace_tpu.models.physics.microphysics` (reference ai2cm/pace
physics/pace/physics/stencils/microphysics.py: fields_init:26-307,
warm_rain:307-760, sedimentation:760-1471, icloud:1471-1719,
fields_update:1719-1852, Microphysics:1897-2533; and
physics/pace/physics/functions/microphysics_funcs.py, the full file).

- Columns are independent: everything is elementwise over (..., nz) tensors
  except a handful of vertical recurrences (implicit sedimentation,
  water-vapor borrowing, sedimentation heating, momentum transport), which
  are Python loops over the levels with all horizontal points vectorized.
- The reference's gt4py FORWARD+BACKWARD `no_fall` flag propagation reduces
  to a per-column any() reduction; ze geometry reduces to a reversed
  cumulative sum.  The reference's `zt` fields only feed the (disabled)
  use_ppm fall scheme and are omitted.
- Scheme constants (setupm, reference microphysics.py:2092-2229) are Python
  floats computed once at construction, so they round like literals in the
  state's dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.ops.stencil_utils import dim as _dim
from pace_torch.ops.stencil_utils import (
    cumsum_k,
    levels,
    maximum,
    minimum,
    reverse_cumsum,
)
from pace_torch.utils import constants as con

# --- constants (reference microphysics_funcs.py:6-42) -----------------------
VCONS = 6.6280504
VCONG = 87.2382675
NORMS = 942477796.076938
NORMG = 5026548245.74367
VCONR = 2503.23638966667
NORMR = 25132741228.7183
THR = 1.0e-8
THI = 1.0e-8
THG = 1.0e-8
THS = 1.0e-8
AA = -4.14122e-5
BB = -0.00538922
CC = -0.0516344
DD_FS = 0.00216078
EE = 1.9714
VR_MIN = 1.0e-3
VF_MIN = 1.0e-5
P_MIN = 100.0
DT_FR = 8.0
SFCRHO = 1.2
RHOS = 1.0e2
RHOG = 4.0e2
RHOR = 1.0e3
QCMIN = 1.0e-12
QRMIN = 1.0e-8
QVMIN = 1.0e-20


def _slog(x):
    """log with a positivity clamp: reference code only evaluates log under
    masks guaranteeing positive arguments; the clamp keeps the unselected
    side of a torch.where finite."""
    return torch.log(maximum(x, 1.0e-30))


def _w(mask, new, old):
    return torch.where(mask, new, old)


# --- saturation vapor functions (analytic; reference funcs.py:55-162) -------


def wqs1(ta, den):
    es = con.E00 * torch.exp(
        (con.DC_VAP * torch.log(ta / con.TICE)
         + con.LV0 * (ta - con.TICE) / (ta * con.TICE)) / con.RVGAS
    )
    return es / (con.RVGAS * ta * den)


def wqs2(ta, den):
    tmp = wqs1(ta, den)
    return tmp, tmp * (con.DC_VAP + con.LV0 / ta) / (con.RVGAS * ta)


def iqs1(ta, den):
    ti = torch.clamp(ta, con.T_SAT_MIN, con.TICE)
    tw = minimum(ta, con.TICE + 102.0)
    ice = con.E00 * torch.exp(
        (con.D2ICE * torch.log(ti / con.TICE)
         + con.LI2 * (ti - con.TICE) / (ti * con.TICE)) / con.RVGAS
    ) / (con.RVGAS * ti * den)
    return torch.where(ta < con.TICE, ice, wqs1(tw, den))


def iqs2(ta, den):
    tmp = iqs1(ta, den)
    ti = maximum(ta, con.T_SAT_MIN)
    tw = minimum(ta, con.TICE + 102.0)
    dice = tmp * (con.D2ICE + con.LI2 / ti) / (con.RVGAS * ti)
    dwat = tmp * (con.DC_VAP + con.LV0 / tw) / (con.RVGAS * tw)
    return tmp, torch.where(ta < con.TICE, dice, dwat)


# --- process functions (reference funcs.py:165-205) --------------------------


def acr3d(v1, v2, q1, q2, c, cac0, cac1, cac2, rho):
    t1 = torch.sqrt(maximum(q1 * rho, 0.0))
    s1 = torch.sqrt(maximum(q2 * rho, 0.0))
    s2 = torch.sqrt(s1)
    return c * torch.abs(v1 - v2) * q1 * s2 * (
        cac0 * t1 + cac1 * torch.sqrt(t1) * s2 + cac2 * s1
    )


def smlt(tc, dqs, qsrho, psacw, psacr, c, rho, rhofac):
    qsrho = maximum(qsrho, 0.0)
    return (c[0] * tc / rho - c[1] * dqs) * (
        c[2] * torch.sqrt(qsrho) + c[3] * qsrho ** 0.65625 * torch.sqrt(rhofac)
    ) + c[4] * tc * (psacw + psacr)


def gmlt(tc, dqs, qgrho, pgacw, pgacr, c, rho):
    qgrho = maximum(qgrho, 0.0)
    return (c[0] * tc / rho - c[1] * dqs) * (
        c[2] * torch.sqrt(qgrho) + c[3] * qgrho ** 0.6875 / rho ** 0.25
    ) + c[4] * tc * (pgacw + pgacr)


def _cvm(c_air, c_vap, qv, q_liq, q_sol):
    return c_air + qv * c_vap + q_liq * con.C_LIQ + q_sol * con.C_ICE


# --- vertical recurrence helpers ---------------------------------------------


def _levels(*arrays):
    return [levels(a) for a in arrays]


def _implicit_fall(q, dp1, dz_pos, vt, dt):
    """Backward-implicit upwind sedimentation (reference
    microphysics.py:516-560 rain / 972-1016 ice, non-PPM path).
    Returns (q_new, m1 cumulative flux, bottom flux)."""
    dd = dt * vt
    qdp = q * dp1

    qm_prev = dd_prev = torch.zeros_like(q[..., 0])
    qm = []
    for qdp_k, dz_k, dd_k in zip(*_levels(qdp, dz_pos, dd)):
        qm_prev = (qdp_k + dd_prev * qm_prev) / (dz_k + dd_k)
        dd_prev = dd_k
        qm.append(qm_prev)
    qm = torch.stack(qm, -1) * dz_pos
    m1 = cumsum_k(qdp - qm)
    return qm / dp1, m1, m1[..., -1]


def _sedi_w(w, dm, m1, vt):
    """Vertical-velocity transport by falling condensate (reference
    microphysics.py:566-596)."""
    m1m = torch.cat([torch.zeros_like(m1[..., :1]), m1[..., :-1]], -1)
    vtm = torch.cat([torch.zeros_like(vt[..., :1]), vt[..., :-1]], -1)
    return (dm * w - m1m * vtm + m1 * vt) / (dm + m1m - m1)


def _sedi_heat(tz, dp1, dz1, m1, qv, ql, qr, qi, qs, qg, cw):
    """Implicit potential-energy heating by sedimentation (reference
    microphysics.py:597-644); cw is C_LIQ for rain, C_ICE for solids."""
    dgz = -0.5 * con.GRAV * dz1
    cvn = dp1 * (
        con.CV_AIR + qv * con.CV_VAP + (qr + ql) * con.C_LIQ
        + (qi + qs + qg) * con.C_ICE
    )
    t_top = tz[..., 0] + m1[..., 0] * dgz[..., 0] / (
        cvn[..., 0] + m1[..., 0] * cw
    )

    tz_l, cvn_l, m1_l, dgz_l = _levels(tz, cvn, m1, dgz)
    t_prev, m1_prev = t_top, m1_l[0]
    out = [t_top]
    for tz_k, cvn_k, m1_k, dgz_k in zip(tz_l[1:], cvn_l[1:], m1_l[1:],
                                        dgz_l[1:]):
        t_prev = (
            (cvn_k + cw * (m1_k - m1_prev)) * tz_k
            + m1_prev * cw * t_prev + dgz_k * (m1_prev + m1_k)
        ) / (cvn_k + cw * m1_k)
        m1_prev = m1_k
        out.append(t_prev)
    return torch.stack(out, -1)


def _no_fall(q):
    """Column flag: True where the whole column has q <= QRMIN.  Collapses
    the reference's FORWARD+BACKWARD flag propagation
    (microphysics.py:383-406) to an any() reduction."""
    return ~torch.any(q > QRMIN, dim=-1, keepdim=True)


def _ze_from_dz(dz1, zs=0.0):
    """Interface heights above the surface: ze[k] = zs - sum_{j>=k} dz1[j]
    (dz1 < 0; reference microphysics.py:411-421)."""
    return zs - reverse_cumsum(dz1)


def _dz_pos(ze, zs=0.0):
    return torch.cat([ze[..., :-1] - ze[..., 1:], ze[..., -1:] - zs], -1)


def _z_slope(q, h_var):
    """Linear mono slope for autoconversions (reference
    microphysics.py:685-733 liquid / 1595-1634 ice)."""
    dq = 0.5 * (q[..., 1:] - q[..., :-1])  # dq[k] = 0.5*(q[k]-q[k-1]), k>=1
    dqm, dqp = dq[..., :-1], dq[..., 1:]  # at interior k: dq[k], dq[k+1]
    qi_ = q[..., 1:-1]
    dl = 0.5 * minimum(torch.abs(dqm + dqp), 0.5 * qi_)
    dl = torch.where(
        dqm * dqp <= 0.0,
        torch.where(
            dqm > 0.0, minimum(dl, minimum(dqm, -dqp)), 0.0
        ),
        dl,
    )
    zero = torch.zeros_like(q[..., :1])
    dl = torch.cat([zero, dl, zero], -1)
    return maximum(dl, maximum(QVMIN, h_var * q))


# --- rain processes (reference funcs.py:208-305, 383-480) -------------------


def revap_racc(dt, nml, c_air, c_vap, d0_vap, lv00, t_wfr, cracw, crevp,
               h_var, qg, qi, ql, qr, qs, qv, tz, den, denfac):
    """Rain evaporation and accretion for a half time step (reference
    funcs.py:208-305 revap_racc)."""
    m0 = (tz > t_wfr) & (qr > QRMIN)
    lhl = lv00 + d0_vap * tz
    q_liq = ql + qr
    q_sol = qi + qs + qg
    cvm = _cvm(c_air, c_vap, qv, q_liq, q_sol)
    lcpk = lhl / cvm
    tin = tz - lcpk * ql
    qpz = qv + ql
    qsat, dqsdt = wqs2(maximum(tin, 80.0), den)
    dqh = maximum(ql, h_var * maximum(qpz, QCMIN))
    dqh = minimum(dqh, 0.2 * qpz)
    dqv = qsat - qv
    q_minus = qpz - dqh
    q_plus = qpz + dqh

    # rain evaporation
    me = m0 & (dqv > QVMIN) & (qsat > q_minus)
    dq = torch.where(
        qsat > q_plus, qsat - qpz,
        0.25 * (q_minus - qsat) ** 2 / maximum(dqh, QCMIN),
    )
    qden = maximum(qr, 0.0) * den
    t2 = tin * tin
    evap = (
        crevp[0] * t2 * dq
        * (crevp[1] * torch.sqrt(qden)
           + crevp[2] * torch.exp(0.725 * _slog(qden)))
        / (crevp[3] * t2 + crevp[4] * qsat * den)
    )
    evap = minimum(qr, minimum(dt * evap, dqv / (1.0 + lcpk * dqsdt)))
    qr = _w(me, qr - evap, qr)
    qv = _w(me, qv + evap, qv)
    q_liq = _w(me, q_liq - evap, q_liq)
    cvm = _cvm(c_air, c_vap, qv, q_liq, q_sol)
    tz = _w(me, tz - evap * lhl / cvm, tz)

    # accretion of cloud water by rain
    ma = m0 & (qr > QRMIN) & (ql > 1.0e-6) & (qsat < q_minus)
    sink = dt * denfac * cracw * torch.exp(
        0.95 * _slog(maximum(qr, 0.0) * den))
    sink = sink / (1.0 + sink) * ql
    ql = _w(ma, ql - sink, ql)
    qr = _w(ma, qr + sink, qr)
    return qg, qi, ql, qr, qs, qv, tz


def fall_speed(nml: PhysicsConfig, log_10, qg, qi, ql, qs, tk, den):
    """Terminal fall speeds of graupel/ice/snow (reference
    funcs.py:308-380)."""
    rhof = torch.sqrt(minimum(10.0, SFCRHO / den))
    if nml.const_vi:
        vti = torch.full_like(qi, nml.vi_fac)
    else:
        vi0 = 0.01 * nml.vi_fac
        tc = tk - nml.tice
        vti = (
            (3.0 + _slog(qi * den) / log_10) * (tc * (AA * tc + BB) + CC)
            + DD_FS * tc + EE
        )
        vti = vi0 * torch.exp(log_10 * minimum(vti, 30.0)) * 0.8
        vti = torch.clamp(vti, VF_MIN, nml.vi_max)
        vti = torch.where(qi < THI, VF_MIN, vti)
    if nml.const_vs:
        vts = torch.full_like(qs, nml.vs_fac)
    else:
        vts = nml.vs_fac * VCONS * rhof * torch.exp(
            0.0625 * _slog(qs * den / NORMS))
        vts = torch.clamp(vts, VF_MIN, nml.vs_max)
        vts = torch.where(qs < THS, VF_MIN, vts)
    if nml.const_vg:
        vtg = torch.full_like(qg, nml.vg_fac)
    else:
        qden = maximum(qg * den / NORMG, 0.0)
        vtg = nml.vg_fac * VCONG * rhof * torch.sqrt(
            torch.sqrt(torch.sqrt(qden)))
        vtg = torch.clamp(vtg, VF_MIN, nml.vg_max)
        vtg = torch.where(qg < THG, VF_MIN, vtg)
    return vtg, vti, vts


def compute_rain_fspeed(nml: PhysicsConfig, no_fall, qrz, den):
    """Rain terminal fall speed (reference funcs.py:383-417)."""
    if nml.const_vr:
        vtrz = torch.full_like(qrz, nml.vr_fac)
    else:
        qden = maximum(qrz, 0.0) * den
        vtrz = (
            nml.vr_fac * VCONR * torch.sqrt(minimum(10.0, SFCRHO / den))
            * torch.exp(0.2 * _slog(qden / NORMR))
        )
        vtrz = torch.clamp(vtrz, VR_MIN, nml.vr_max)
        vtrz = torch.where(qrz < THR, VR_MIN, vtrz)
    return torch.where(no_fall, VF_MIN, vtrz)


def autoconv_no_subgrid_var(use_ccn, fac_rc, t_wfr, so3, dt_rain, qlz, qrz,
                            tz, den, ccn, c_praut):
    """Cloud water -> rain autoconversion, no subgrid variability
    (reference funcs.py:420-445)."""
    qc0 = fac_rc * ccn
    qc = qc0 if use_ccn else qc0 / den
    dq = qlz - qc
    m = (tz > t_wfr) & (dq > 0.0)
    sink = minimum(
        dq, dt_rain * c_praut * den * torch.exp(so3 * _slog(qlz))
    )
    return _w(m, qlz - sink, qlz), _w(m, qrz + sink, qrz)


def autoconv_subgrid_var(use_ccn, fac_rc, t_wfr, so3, dt_rain, qlz, qrz, tz,
                         den, ccn, c_praut, dl):
    """Cloud water -> rain autoconversion with subgrid variability
    (reference funcs.py:448-480)."""
    qc0 = fac_rc * ccn
    dl = minimum(maximum(1.0e-6, dl), 0.5 * qlz)
    qc = qc0 if use_ccn else qc0 / den
    dq = 0.5 * (qlz + dl - qc)
    m = (tz > t_wfr + DT_FR) & (dq > 0.0)
    sink = (
        minimum(1.0, dq / maximum(dl, QCMIN)) * dt_rain * c_praut
        * den * torch.exp(so3 * _slog(qlz))
    )
    return _w(m, qlz - sink, qlz), _w(m, qrz + sink, qrz)


# --- subgrid_z_proc (reference funcs.py:483-938) -----------------------------


def subgrid_z_proc(nml: PhysicsConfig, consts, dts, h_var, rh_adj, rh_rain,
                   qaz, qgz, qiz, qlz, qrz, qsz, qvz, tz, den, denfac, p1):
    """Temperature-sensitive high-vertical-resolution processes: instant
    deposition, cloud water evap/cond, freezing, ice & snow & graupel
    sublimation/deposition, rain min-evap, cloud fraction."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    d0_vap, lv00 = consts["d0_vap"], consts["lv00"]
    cssub = consts["cssub"]
    t_wfr, tice, t_sub = consts["t_wfr"], nml.tice, nml.t_sub
    fac_v2g, fac_g2v = consts["fac_v2g"], consts["fac_g2v"]
    fac_l2v = consts["fac_l2v"]

    lhl = lv00 + d0_vap * tz
    lhi = con.LI00 + con.DC_ICE * tz
    q_liq = qlz + qrz
    q_sol = qiz + qsz + qgz
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    lcpk = lhl / cvm
    icpk = lhi / cvm
    tcpk = lcpk + icpk
    tcp3 = lcpk + icpk * minimum(1.0, _dim(tice, tz) / (tice - t_wfr))

    pm = p1 >= P_MIN

    # instant deposit all water vapor to ice at super-low temperature
    mcold = pm & (tz < con.T_MIN)
    sink = _dim(1.0e-7, qvz)
    qvz = _w(mcold, qvz - sink, qvz)
    qiz = _w(mcold, qiz + sink, qiz)
    q_sol = _w(mcold, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mcold, tz + sink * (lhl + lhi) / cvm, tz)
    if not nml.do_qa:
        qaz = _w(mcold, qaz + 1.0, qaz)

    m = pm & ~mcold  # main branch
    lhl = lv00 + d0_vap * tz
    lhi = con.LI00 + con.DC_ICE * tz
    lcpk = lhl / cvm
    icpk = lhi / cvm
    tcpk = lcpk + icpk
    tcp3 = lcpk + icpk * minimum(1.0, _dim(tice, tz) / (tice - t_wfr))

    # instant evaporation/sublimation of all clouds if rh < rh_adj
    qpz = qvz + qlz + qiz
    tin = tz - (lhl * (qlz + qiz) + lhi * qiz) / (
        c_air + qpz * c_vap + qrz * con.C_LIQ + (qsz + qgz) * con.C_ICE
    )
    rh = qpz / iqs1(maximum(tin, 80.0), den)
    mclear = m & (tin > t_sub + 6.0) & (rh < rh_adj)
    tz = _w(mclear, tin, tz)
    qvz = _w(mclear, qpz, qvz)
    qlz = _w(mclear, 0.0, qlz)
    qiz = _w(mclear, 0.0, qiz)

    m = m & ~mclear

    # cloud water <--> vapor adjustment
    qsw, dwsdt = wqs2(tz, den)
    dq0 = qsw - qvz
    factor = minimum(1.0, fac_l2v * (10.0 * dq0 / maximum(qsw, QCMIN)))
    evap = torch.where(
        dq0 > 0.0,
        minimum(qlz, factor * dq0 / (1.0 + tcp3 * dwsdt)),
        dq0 / (1.0 + tcp3 * dwsdt),
    )
    qvz = _w(m, qvz + evap, qvz)
    qlz = _w(m, qlz - evap, qlz)
    q_liq = _w(m, q_liq - evap, q_liq)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(m, tz - evap * lhl / cvm, tz)

    # complete freezing below -48C
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    dtmp = t_wfr - tz
    mf = m & (dtmp > 0.0) & (qlz > QCMIN)
    sink = minimum(qlz, minimum(qlz * dtmp * 0.125, dtmp / icpk))
    qlz = _w(mf, qlz - sink, qlz)
    qiz = _w(mf, qiz + sink, qiz)
    q_liq = _w(mf, q_liq - sink, q_liq)
    q_sol = _w(mf, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mf, tz + sink * lhi / cvm, tz)

    # Bigg mechanism (only when fast_sat_adj is off)
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    if nml.fast_sat_adj:
        dt_pisub = 0.5 * dts
    else:
        dt_pisub = dts
        tc = tice - tz
        mb = m & (qlz > QRMIN) & (tc > 0.0)
        sink = 3.3333e-10 * dts * (
            torch.exp(0.66 * minimum(tc, 100.0)) - 1.0) * den * qlz * qlz
        sink = minimum(qlz, minimum(tc / icpk, sink))
        qlz = _w(mb, qlz - sink, qlz)
        qiz = _w(mb, qiz + sink, qiz)
        q_liq = _w(mb, q_liq - sink, q_liq)
        q_sol = _w(mb, q_sol + sink, q_sol)
        cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
        tz = _w(mb, tz + sink * lhi / cvm, tz)

    # sublimation / deposition of ice
    lhl = lv00 + d0_vap * tz
    lhi = con.LI00 + con.DC_ICE * tz
    lcpk = lhl / cvm
    icpk = lhi / cvm
    tcpk = lcpk + icpk
    mi = m & (tz < tice)
    qsi, dqsdt = iqs2(tz, den)
    dq = qvz - qsi
    sink0 = dq / (1.0 + tcpk * dqsdt)
    pidep = (
        dt_pisub * dq * 349138.78
        * torch.exp(0.875 * _slog(maximum(qiz, 0.0) * den))
        / (qsi * den * con.LAT2 / (0.0243 * con.RVGAS * tz ** 2) + 4.42478e4)
    )
    pidep = torch.where(qiz > QRMIN, pidep, 0.0)
    tmp = tice - tz
    qi_crt = nml.qi_gen * minimum(nml.qi_lim, 0.1 * tmp) / den
    sink_dep = minimum(
        sink0,
        minimum(maximum(qi_crt - qiz, pidep), tmp / tcpk),
    )
    pidep_sub = pidep * minimum(1.0, _dim(tz, t_sub) * 0.2)
    sink_sub = maximum(pidep_sub, maximum(sink0, -qiz))
    sink = torch.where(dq > 0.0, sink_dep, sink_sub)
    qvz = _w(mi, qvz - sink, qvz)
    qiz = _w(mi, qiz + sink, qiz)
    q_sol = _w(mi, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mi, tz + sink * (lhl + lhi) / cvm, tz)

    # sublimation / deposition of snow (whole temperature range)
    lhl = lv00 + d0_vap * tz
    lhi = con.LI00 + con.DC_ICE * tz
    lcpk = lhl / cvm
    icpk = lhi / cvm
    tcpk = lcpk + icpk
    ms = m & (qsz > QRMIN)
    qsi, dqsdt = iqs2(tz, den)
    qden = maximum(qsz, 0.0) * den
    tmp = torch.exp(0.65625 * _slog(qden))
    tsq = tz * tz
    dq = (qsi - qvz) / (1.0 + tcpk * dqsdt)
    pssub = (
        cssub[0] * tsq
        * (cssub[1] * torch.sqrt(qden) + cssub[2] * tmp * torch.sqrt(denfac))
        / (cssub[3] * tsq + cssub[4] * qsi * den)
    )
    pssub = (qsi - qvz) * dts * pssub
    pssub = torch.where(
        pssub > 0.0,
        minimum(pssub * minimum(1.0, _dim(tz, t_sub) * 0.2), qsz),
        torch.where(
            tz > tice, 0.0,
            maximum(pssub, maximum(dq, (tz - tice) / tcpk)),
        ),
    )
    qsz = _w(ms, qsz - pssub, qsz)
    qvz = _w(ms, qvz + pssub, qvz)
    q_sol = _w(ms, q_sol - pssub, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(ms, tz - pssub * (lhl + lhi) / cvm, tz)

    # simplified 2-way graupel sublimation-deposition
    lhl = lv00 + d0_vap * tz
    lhi = con.LI00 + con.DC_ICE * tz
    lcpk = lhl / cvm
    icpk = lhi / cvm
    tcpk = lcpk + icpk
    mg = m & (qgz > QRMIN)
    qsi, dqsdt = iqs2(tz, den)
    dq = (qvz - qsi) / (1.0 + tcpk * dqsdt)
    pgsub = (qvz / qsi - 1.0) * qgz
    pgsub = torch.where(
        pgsub > 0.0,
        torch.where(
            tz > tice, 0.0,
            minimum(
                minimum(fac_v2g * pgsub, 0.2 * dq),
                minimum(qlz + qrz, (tice - tz) / tcpk),
            ),
        ),
        maximum(fac_g2v * pgsub, dq) * minimum(1.0, _dim(tz, t_sub) * 0.1),
    )
    qgz = _w(mg, qgz + pgsub, qgz)
    qvz = _w(mg, qvz - pgsub, qvz)
    q_sol = _w(mg, q_sol + pgsub, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mg, tz + pgsub * (lhl + lhi) / cvm, tz)

    # minimum evap of rain in dry environmental air (USE_MIN_EVAP)
    lhl = lv00 + d0_vap * tz
    lcpk = lhl / cvm
    mr = m & (qrz > QCMIN)
    qsw, dqsdt = wqs2(tz, den)
    sink = minimum(qrz, _dim(rh_rain * qsw, qvz) / (1.0 + lcpk * dqsdt))
    qvz = _w(mr, qvz + sink, qvz)
    qrz = _w(mr, qrz - sink, qrz)
    q_liq = _w(mr, q_liq - sink, q_liq)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mr, tz - sink * lhl / cvm, tz)

    # cloud fraction (only when the fast sat-adj does not own qa)
    if not nml.do_qa:
        lhl = lv00 + d0_vap * tz
        cvm = c_air + (qvz + q_liq + q_sol) * c_vap
        lcpk = lhl / cvm
        q_sol_cf = qiz + qsz if nml.rad_snow else qiz
        q_liq_cf = qlz + qrz if nml.rad_rain else qlz
        q_cond = q_liq_cf + q_sol_cf
        qpz = qvz + q_cond
        tin = tz - (lcpk * q_cond + icpk * q_sol_cf)
        tin_s = maximum(tin, 80.0)
        qsi_ = iqs1(tin_s, den)
        qsw_ = wqs1(tin_s, den)
        rqi = torch.where(
            q_cond > 3.0e-6, q_sol_cf / maximum(q_cond, QCMIN),
            (tice - tin) / (tice - t_wfr),
        )
        qstar = torch.where(
            tin <= t_wfr, qsi_,
            torch.where(tin >= tice, qsw_, rqi * qsi_ + (1.0 - rqi) * qsw_),
        )
        dq = maximum(QCMIN, h_var * qpz)
        q_plus = qpz + dq
        q_minus = qpz - dq
        mq = m & (qpz > QRMIN)
        qaz = _w(mq & (qstar < q_minus), qaz + 1.0, qaz)
        qaz = _w(
            mq & (qstar >= q_minus) & (qstar < q_plus) & (q_cond > nml.qc_crt),
            qaz + (q_plus - qstar) / (dq + dq), qaz,
        )

    return qaz, qgz, qiz, qlz, qrz, qsz, qvz, tz


# --- icloud_main (reference funcs.py:941-1384) ------------------------------


def _icloud_warm(nml, consts, dts, rdts, dqs0, qgz, qiz, qlz, qrz, qsz, qvz,
                 tz, den, denfac, vtgz, vtrz, vtsz, q_liq, q_sol, cvm, active):
    """tc >= 0 branch: melting of snow and graupel (funcs.py:1022-1152)."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    csmlt, cgmlt = consts["csmlt"], consts["cgmlt"]
    tice = nml.tice
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    tc = tz - tice

    # melting of snow
    msnow = active & (qsz > QCMIN)
    factor = denfac * consts["csacw"] * torch.exp(
        0.8125 * _slog(maximum(qsz, 0.0) * den)
    )
    psacw = torch.where(qlz > QRMIN, factor / (1.0 + dts * factor) * qlz, 0.0)
    has_r = qrz > QRMIN
    psacr = torch.where(
        has_r,
        minimum(
            acr3d(vtsz, vtrz, qrz, qsz, consts["csacr"],
                  consts["acco"][0][1], consts["acco"][1][1],
                  consts["acco"][2][1], den),
            qrz * rdts,
        ),
        0.0,
    )
    pracs = torch.where(
        has_r,
        acr3d(vtrz, vtsz, qsz, qrz, consts["cracs"], consts["acco"][0][0],
              consts["acco"][1][0], consts["acco"][2][0], den),
        0.0,
    )
    psmlt = maximum(
        0.0, smlt(tc, dqs0, qsz * den, psacw, psacr, csmlt, den, denfac)
    )
    sink = minimum(qsz, minimum(dts * (psmlt + pracs), tc / icpk))
    qsz = _w(msnow, qsz - sink, qsz)
    tmp = minimum(sink, _dim(nml.qs_mlt, qlz))
    qlz = _w(msnow, qlz + tmp, qlz)
    qrz = _w(msnow, qrz + sink - tmp, qrz)
    q_liq = _w(msnow, q_liq + sink, q_liq)
    q_sol = _w(msnow, q_sol - sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(msnow, tz - sink * lhi / cvm, tz)
    tc = tz - tice

    # melting of graupel
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    mg = active & (qgz > QCMIN) & (tc > 0.0)
    pgacr = torch.where(
        qrz > QRMIN,
        minimum(
            acr3d(vtgz, vtrz, qrz, qgz, consts["cgacr"],
                  consts["acco"][0][2], consts["acco"][1][2],
                  consts["acco"][2][2], den),
            rdts * qrz,
        ),
        0.0,
    )
    qden = maximum(qgz, 0.0) * den
    factor = consts["cgacw"] * qden / torch.sqrt(
        den * torch.sqrt(torch.sqrt(maximum(qden, 1e-30)))
    )
    pgacw = torch.where(qlz > QRMIN, factor / (1.0 + dts * factor) * qlz, 0.0)
    pgmlt = dts * gmlt(tc, dqs0, qden, pgacw, pgacr, cgmlt, den)
    pgmlt = minimum(maximum(0.0, pgmlt), minimum(qgz, tc / icpk))
    qgz = _w(mg, qgz - pgmlt, qgz)
    qrz = _w(mg, qrz + pgmlt, qrz)
    q_liq = _w(mg, q_liq + pgmlt, q_liq)
    q_sol = _w(mg, q_sol - pgmlt, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mg, tz - pgmlt * lhi / cvm, tz)
    return qgz, qiz, qlz, qrz, qsz, tz, q_liq, q_sol, cvm


def _icloud_cold(nml, consts, dts, rdts, fac_i2s, qgz, qiz, qlz, qrz, qsz,
                 qvz, tz, den, denfac, vtgz, vtrz, vtsz, di, q_liq, q_sol,
                 cvm, active):
    """tc < 0 branch: ice-phase processes (funcs.py:1154-1340)."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    tice = nml.tice
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    tc = tz - tice

    # psaci: accretion of cloud ice by snow; psaut: ice -> snow autoconversion
    mi = active & (qiz > 3.0e-7)
    factor = dts * denfac * consts["csaci"] * torch.exp(
        minimum(0.05 * tc, 0.0) + 0.8125 * _slog(maximum(qsz, 0.0) * den)
    )
    psaci = torch.where(qsz > 1.0e-7, factor / (1.0 + factor) * qiz, 0.0)
    qim = nml.qi0_crt / den
    tmp = fac_i2s if nml.const_vi else fac_i2s * torch.exp(
        minimum(0.025 * tc, 0.0)
    )
    di_ = maximum(di, QRMIN)
    q_plus = qiz + di_
    dq = torch.where(qim > qiz - di_, 0.25 * (q_plus - qim) ** 2 / di_,
                     qiz - qim)
    psaut = torch.where(q_plus > qim + QRMIN, tmp * dq, 0.0)
    sink = minimum(0.75 * qiz, psaci + psaut)
    qiz = _w(mi, qiz - sink, qiz)
    qsz = _w(mi, qsz + sink, qsz)

    # pgaci: accretion of cloud ice by graupel
    mgi = mi & (qgz > 1.0e-6)
    factor = dts * consts["cgaci"] * torch.sqrt(den) * qgz
    pgaci = factor / (1.0 + factor) * qiz
    qiz = _w(mgi, qiz - pgaci, qiz)
    qgz = _w(mgi, qgz + pgaci, qgz)

    # cold-rain: psacr + pgfr
    tc = tz - tice
    mr = active & (qrz > 1.0e-7) & (tc < 0.0)
    psacr = torch.where(
        qsz > 1.0e-7,
        dts * acr3d(vtsz, vtrz, qrz, qsz, consts["csacr"],
                    consts["acco"][0][1], consts["acco"][1][1],
                    consts["acco"][2][1], den),
        0.0,
    )
    pgfr = (
        dts * consts["cgfr"][0] / den
        * (torch.exp(minimum(-consts["cgfr"][1] * tc, 50.0)) - 1.0)
        * torch.exp(1.75 * _slog(maximum(qrz, 0.0) * den))
    )
    sink = psacr + pgfr
    factor = minimum(sink, minimum(qrz, -tc / icpk)) / maximum(
        sink, QRMIN
    )
    psacr = factor * psacr
    pgfr = factor * pgfr
    sink = psacr + pgfr
    qrz = _w(mr, qrz - sink, qrz)
    qsz = _w(mr, qsz + psacr, qsz)
    qgz = _w(mr, qgz + pgfr, qgz)
    q_liq = _w(mr, q_liq - sink, q_liq)
    q_sol = _w(mr, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mr, tz + sink * lhi / cvm, tz)

    # graupel production from snow
    lhi = con.LI00 + con.DC_ICE * tz
    icpk = lhi / cvm
    msn = active & (qsz > 1.0e-7)
    sink = torch.where(
        qgz > QRMIN,
        dts * acr3d(vtgz, vtsz, qsz, qgz, consts["cgacs"],
                    consts["acco"][0][3], consts["acco"][1][3],
                    consts["acco"][2][3], den),
        0.0,
    )
    qsm = nml.qs0_crt / den
    factor = dts * 1.0e-3 * torch.exp(minimum(0.09 * (tz - tice), 0.0))
    sink = sink + torch.where(
        qsz > qsm, factor / (1.0 + factor) * (qsz - qsm), 0.0
    )
    sink = minimum(qsz, sink)
    qsz = _w(msn, qsz - sink, qsz)
    qgz = _w(msn, qgz + sink, qgz)

    # graupel accretion of cloud water and rain
    mga = active & (qgz > 1.0e-7) & (tz < consts["tice0"])
    qden = maximum(qgz, 0.0) * den
    factor = dts * consts["cgacw"] * qden / torch.sqrt(
        den * torch.sqrt(torch.sqrt(maximum(qden, 1e-30)))
    )
    pgacw = torch.where(qlz > 1.0e-6, factor / (1.0 + factor) * qlz, 0.0)
    pgacr = torch.where(
        qrz > 1.0e-6,
        minimum(
            dts * acr3d(vtgz, vtrz, qrz, qgz, consts["cgacr"],
                        consts["acco"][0][2], consts["acco"][1][2],
                        consts["acco"][2][2], den),
            qrz,
        ),
        0.0,
    )
    sink = pgacr + pgacw
    factor = minimum(sink, _dim(tice, tz) / icpk) / maximum(sink, QRMIN)
    pgacr = factor * pgacr
    pgacw = factor * pgacw
    sink = pgacr + pgacw
    qgz = _w(mga, qgz + sink, qgz)
    qrz = _w(mga, qrz - pgacr, qrz)
    qlz = _w(mga, qlz - pgacw, qlz)
    q_liq = _w(mga, q_liq - sink, q_liq)
    q_sol = _w(mga, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mga, tz + sink * lhi / cvm, tz)
    return qgz, qiz, qlz, qrz, qsz, tz, q_liq, q_sol, cvm


def icloud_main(nml, consts, dts, rdts, h_var, rh_adj, rh_rain, qaz, qgz,
                qiz, qlz, qrz, qsz, qvz, tz, den, denfac, vtgz, vtrz, vtsz,
                p1, di, q_liq, q_sol, cvm):
    """Ice-phase sources/sinks followed by subgrid_z_proc
    (funcs.py:941-1384)."""
    pm = p1 >= P_MIN
    tc0 = tz - nml.tice
    warm = pm & (tc0 >= 0.0)
    cold = pm & (tc0 < 0.0)
    dqs0 = consts["ces0"] / p1 - qvz

    wq = _icloud_warm(nml, consts, dts, rdts, dqs0, qgz, qiz, qlz, qrz, qsz,
                      qvz, tz, den, denfac, vtgz, vtrz, vtsz, q_liq, q_sol,
                      cvm, warm)
    cq = _icloud_cold(nml, consts, dts, rdts, consts["fac_i2s"], qgz, qiz,
                      qlz, qrz, qsz, qvz, tz, den, denfac, vtgz, vtrz, vtsz,
                      di, q_liq, q_sol, cvm, cold)
    sel = tc0 >= 0.0
    qgz, qiz, qlz, qrz, qsz, tz = (
        torch.where(sel, a, b) for a, b in zip(wq[:6], cq[:6])
    )

    return subgrid_z_proc(
        nml, consts, dts, h_var, rh_adj, rh_rain, qaz, qgz, qiz, qlz, qrz,
        qsz, qvz, tz, den, denfac, p1,
    )


# --- stencil-level stages ---------------------------------------------------


def fields_init(nml: PhysicsConfig, consts, land, area, qa, qg, qi, ql, qn,
                qr, qs, qv, pt, delp, dz, qi_dt, qs_dt, uin, vin, dt_in, rdt):
    """Moist->dry conversion, CCN, subgrid variability, negative fixer
    (reference microphysics.py:26-307).  Returns the working-state dict."""
    if nml.de_ice:
        qio = qi - dt_in * qi_dt
        qin = maximum(qio, nml.qi0_max)
        md = qi > qin
        qs = _w(md, qs + qi - qin, qs)
        dqi = (qin - qio) * rdt
        qs_dt = _w(md, qs_dt + qi_dt - dqi, qs_dt)
        qi_dt = _w(md, dqi, qi_dt)
        qi = _w(md, qin, qi)

    t0 = pt
    tz = t0
    dp0 = delp
    dp1 = delp * (1.0 - qv)
    omq = dp0 / dp1
    qvz = qv * omq
    qlz = ql * omq
    qrz = qr * omq
    qiz = qi * omq
    qsz = qs * omq
    qgz = qg * omq
    qa0 = qa
    dz0 = dz
    den0 = -dp1 / (con.GRAV * dz0)
    p1 = den0 * con.RDGAS * t0

    # CCN (Klein eq. 15); surface value propagated through the column
    if nml.prog_ccn:
        # floor: a zero prognostic droplet number would give
        # c_praut = 0**(-1/3) = inf (latent hazard in the reference too)
        ccn = maximum(qn, 1.0e-2) * 1.0e6
    else:
        ccn2d = (nml.ccn_l * land + nml.ccn_o * (1.0 - land)) * 1.0e6
        ccn = torch.broadcast_to(ccn2d[..., None], tz.shape)
        # use_ccn: scale by surface den/den_surface via ideal gas at bottom
        ccn = ccn * (con.RDGAS * tz[..., -1:] / p1[..., -1:])
    c_praut = consts["cpaut"] * (ccn * RHOR) ** (-1.0 / 3.0)

    # horizontal subgrid variability (dx ~ 100 km base)
    s_leng = torch.sqrt(torch.sqrt(area * 1.0e-10))
    t_land = nml.dw_land * s_leng
    t_ocean = nml.dw_ocean * s_leng
    h_var = t_land * land + t_ocean * (1.0 - land)
    h_var = torch.clamp(h_var, 0.01, 0.2)[..., None]
    rh_adj = 1.0 - h_var - nml.rh_inc
    rh_rain = maximum(0.35, rh_adj - nml.rh_inr)

    if nml.fix_negative:
        cvm = _cvm(consts["c_air"], consts["c_vap"], qvz, qrz + qlz,
                   qiz + qsz + qgz)
        lcpk = (consts["lv00"] + consts["d0_vap"] * tz) / cvm
        icpk = (con.LI00 + con.DC_ICE * tz) / cvm
        # ice phase: qi<0 -> qs; qs<0 -> qg; qg<0 -> qr (heating)
        qsz = torch.where(qiz < 0.0, qsz + qiz, qsz)
        qiz = maximum(qiz, 0.0)
        qgz = torch.where(qsz < 0.0, qgz + qsz, qgz)
        qsz = maximum(qsz, 0.0)
        qrz = torch.where(qgz < 0.0, qrz + qgz, qrz)
        tz = torch.where(qgz < 0.0, tz - qgz * icpk, tz)
        qgz = maximum(qgz, 0.0)
        # liquid phase: qr<0 -> ql; ql<0 -> qv (heating)
        qlz = torch.where(qrz < 0.0, qlz + qrz, qlz)
        qrz = maximum(qrz, 0.0)
        qvz = torch.where(qlz < 0.0, qvz + qlz, qvz)
        tz = torch.where(qlz < 0.0, tz - qlz * lcpk, tz)
        qlz = maximum(qlz, 0.0)

        # fix water vapor: borrow from the layer below (downward sweep)
        qv_l, dp_l = _levels(qvz, dp1)
        qv_prev, dp_prev = qv_l[0], dp_l[0]
        swept = [qv_prev]
        for qv_k, dp_k in zip(qv_l[1:], dp_l[1:]):
            qv_prev = qv_k + torch.where(
                qv_prev < 0.0, qv_prev * dp_prev / dp_k, 0.0
            )
            dp_prev = dp_k
            swept.append(qv_prev)
        qvz = torch.stack(swept, -1)
        qvz = torch.cat(
            [maximum(qvz[..., :-1], 0.0), qvz[..., -1:]], -1
        )
        # bottom layer: borrow from above
        qv_b, qv_a = qvz[..., -1], qvz[..., -2]
        dp_b, dp_a = dp1[..., -1], dp1[..., -2]
        flag = (qv_b < 0.0) & (qv_a > 0.0)
        dq = minimum(-qv_b * dp_b, qv_a * dp_a)
        qv_a = torch.where(flag, qv_a - dq / dp_a, qv_a)
        qv_b = torch.where(flag, qv_b + dq / dp_b, qv_b)
        qvz = torch.cat(
            [qvz[..., :-2], qv_a[..., None], qv_b[..., None]], -1
        )

    zeros2d = torch.zeros_like(tz[..., 0])
    return dict(
        qvz=qvz, qlz=qlz, qrz=qrz, qiz=qiz, qsz=qsz, qgz=qgz,
        qaz=torch.zeros_like(tz), tz=tz, t0=t0, dp0=dp0, dp1=dp1, p1=p1,
        den0=den0, dz0=dz0, m1=torch.zeros_like(tz), ccn=ccn, c_praut=c_praut,
        h_var=h_var, rh_adj=rh_adj, rh_rain=rh_rain,
        qa0=qa0, qg0=qgz, qi0=qiz, ql0=qlz, qr0=qrz, qs0=qsz, qv0=qvz,
        u0=uin, v0=vin, u1=uin, v1=vin,
        rain=zeros2d, snow=zeros2d, ice=zeros2d, graupel=zeros2d,
        qi_dt=qi_dt, qs_dt=qs_dt,
    )


def warm_rain(nml: PhysicsConfig, consts, s, w, dt_rain, is_first):
    """Warm-rain processes: rain sedimentation (implicit), evap/accretion
    half-steps, autoconversion (reference microphysics.py:307-760)."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    d0_vap, lv00 = consts["d0_vap"], consts["lv00"]
    t_wfr = consts["t_wfr"]
    so3 = 7.0 / 3.0
    dt5 = 0.5 * dt_rain
    qgz, qiz, qlz, qrz = s["qgz"], s["qiz"], s["qlz"], s["qrz"]
    qsz, qvz, tz = s["qsz"], s["qvz"], s["tz"]
    dp1 = s["dp1"]

    if is_first:
        # hydrostatic air density update (p_nonhydro=False as in the
        # reference class, microphysics.py:1927)
        dz1 = s["dz0"] * tz / s["t0"]
        den = s["den0"] * s["dz0"] / dz1
        denfac = torch.sqrt(SFCRHO / den)
    else:
        dz1, den, denfac = s["dz1"], s["den"], s["denfac"]

    no_fall = _no_fall(qrz)
    vtrz = compute_rain_fspeed(nml, no_fall, qrz, den)
    ze = _ze_from_dz(dz1)

    live = ~no_fall
    rq = revap_racc(dt5, nml, c_air, c_vap, d0_vap, lv00, t_wfr,
                    consts["cracw"], consts["crevp"], s["h_var"], qgz, qiz,
                    qlz, qrz, qsz, qvz, tz, den, denfac)
    qgz, qiz, qlz, qrz, qsz, qvz, tz = (
        torch.where(live, a, b)
        for a, b in zip(rq, (qgz, qiz, qlz, qrz, qsz, qvz, tz))
    )

    if nml.do_sedi_w and not nml.hydrostatic:
        dm = dp1 * (1.0 + qvz + qlz + qrz + qiz + qsz + qgz)

    # implicit sedimentation of rain (use_ppm=False path)
    dzp = _dz_pos(ze)
    qr_new, m1_rain, r1 = _implicit_fall(qrz, dp1, dzp, vtrz, dt_rain)
    qrz = torch.where(live, qr_new, qrz)
    m1_rain = torch.where(live, m1_rain, 0.0)
    r1 = torch.where(live[..., 0], r1, 0.0)
    if nml.do_sedi_w and not nml.hydrostatic:
        w = torch.where(live, _sedi_w(w, dm, m1_rain, vtrz), w)
    if nml.do_sedi_heat:
        tz = torch.where(
            live,
            _sedi_heat(tz, dp1, dz1, m1_rain, qvz, qlz, qrz, qiz, qsz, qgz,
                       con.C_LIQ),
            tz,
        )

    rq = revap_racc(dt5, nml, c_air, c_vap, d0_vap, lv00, t_wfr,
                    consts["cracw"], consts["crevp"], s["h_var"], qgz, qiz,
                    qlz, qrz, qsz, qvz, tz, den, denfac)
    qgz, qiz, qlz, qrz, qsz, qvz, tz = (
        torch.where(live, a, b)
        for a, b in zip(rq, (qgz, qiz, qlz, qrz, qsz, qvz, tz))
    )

    # autoconversion cloud water -> rain
    use_ccn = not nml.prog_ccn
    if nml.irain_f != 0:
        qlz, qrz = autoconv_no_subgrid_var(
            use_ccn, consts["fac_rc"], t_wfr, so3, dt_rain, qlz, qrz, tz,
            den, s["ccn"], s["c_praut"],
        )
    else:
        if nml.z_slope_liq:
            dl = _z_slope(qlz, s["h_var"])
        else:
            dl = maximum(QVMIN, s["h_var"] * qlz)
        qlz, qrz = autoconv_subgrid_var(
            use_ccn, consts["fac_rc"], t_wfr, so3, dt_rain, qlz, qrz, tz,
            den, s["ccn"], s["c_praut"], dl,
        )

    s = dict(s)
    s.update(qgz=qgz, qiz=qiz, qlz=qlz, qrz=qrz, qsz=qsz, qvz=qvz, tz=tz,
             dz1=dz1, den=den, denfac=denfac, vtrz=vtrz,
             rain=s["rain"] + r1)
    if is_first:
        s["m1"] = s["m1"] + m1_rain
    else:
        s["m1"] = s["m1"] + m1_rain + s["m1_sol"]
    return s, w


def sedimentation(nml: PhysicsConfig, consts, s, w, dts):
    """Terminal fall of cloud ice, snow, graupel with pre-fall ice melt
    (reference microphysics.py:760-1471, non-PPM path)."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    qgz, qiz, qlz, qrz = s["qgz"], s["qiz"], s["qlz"], s["qrz"]
    qsz, qvz, tz = s["qsz"], s["qvz"], s["tz"]
    dp1, dz1, den = s["dp1"], s["dz1"], s["den"]

    vtgz, vtiz, vtsz = fall_speed(nml, consts["log_10"], qgz, qiz, qlz, qsz,
                                  tz, den)
    m1_sol = torch.zeros_like(tz)
    lhi = con.LI00 + con.DC_ICE * tz
    q_liq = qlz + qrz
    q_sol = qiz + qsz + qgz
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    icpk = lhi / cvm

    # significant melting level: stop_k = 1 from the first k with tz > tice
    # downward, always 1 at the bottom (reference 807-832)
    stop_k = torch.cumsum((tz > nml.tice).to(tz.dtype), -1) > 0.0
    stop_k[..., -1] = True

    # melting of cloud ice before fall
    tc = tz - nml.tice
    mm = stop_k & (qiz > QCMIN) & (tc > 0.0)
    sink = minimum(qiz, consts["fac_imlt"] * tc / icpk)
    tmp = minimum(sink, _dim(nml.ql_mlt, qlz))
    qlz = _w(mm, qlz + tmp, qlz)
    qrz = _w(mm, qrz + sink - tmp, qrz)
    qiz = _w(mm, qiz - sink, qiz)
    q_liq = _w(mm, q_liq + sink, q_liq)
    q_sol = _w(mm, q_sol - sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mm, tz - sink * lhi / cvm, tz)
    # melting of FALLING ice/snow/graupel is disabled in the reference
    # (stop_k zeroed at microphysics.py:860-867), so no further use of stop_k

    ze = _ze_from_dz(dz1)
    dzp = _dz_pos(ze)

    def do_sedi_w_mass():
        return dp1 * (1.0 + qvz + qlz + qrz + qiz + qsz + qgz)

    i1 = torch.zeros_like(tz[..., 0])
    # --- ice ---
    if nml.vi_fac >= 1.0e-5:
        live = ~_no_fall(qiz)
        if nml.do_sedi_w:
            dm = do_sedi_w_mass()
        qi_new, m1_tf, bot = _implicit_fall(qiz, dp1, dzp, vtiz, dts)
        qiz = torch.where(live, qi_new, qiz)
        m1_tf = torch.where(live, m1_tf, 0.0)
        i1 = torch.where(live[..., 0], bot, 0.0)
        m1_sol = m1_sol + m1_tf
        if nml.do_sedi_w:
            w = torch.where(live, _sedi_w(w, dm, m1_tf, vtiz), w)

    # --- snow ---
    live = ~_no_fall(qsz)
    if nml.do_sedi_w:
        dm = do_sedi_w_mass()
    qs_new, m1_tf, bot = _implicit_fall(qsz, dp1, dzp, vtsz, dts)
    qsz = torch.where(live, qs_new, qsz)
    m1_tf = torch.where(live, m1_tf, 0.0)
    s1 = torch.where(live[..., 0], bot, 0.0)
    m1_sol = m1_sol + m1_tf
    if nml.do_sedi_w:
        w = torch.where(live, _sedi_w(w, dm, m1_tf, vtsz), w)

    # --- graupel ---
    live = ~_no_fall(qgz)
    if nml.do_sedi_w:
        dm = do_sedi_w_mass()
    qg_new, m1_tf, bot = _implicit_fall(qgz, dp1, dzp, vtgz, dts)
    qgz = torch.where(live, qg_new, qgz)
    m1_tf = torch.where(live, m1_tf, 0.0)
    g1 = torch.where(live[..., 0], bot, 0.0)
    m1_sol = m1_sol + m1_tf
    if nml.do_sedi_w:
        w = torch.where(live, _sedi_w(w, dm, m1_tf, vtgz), w)

    if nml.do_sedi_heat:
        tz = _sedi_heat(tz, dp1, dz1, m1_sol, qvz, qlz, qrz, qiz, qsz, qgz,
                        con.C_ICE)

    s = dict(s)
    s.update(qgz=qgz, qiz=qiz, qlz=qlz, qrz=qrz, qsz=qsz, tz=tz,
             m1_sol=m1_sol, vtgz=vtgz, vtsz=vtsz,
             snow=s["snow"] + s1, graupel=s["graupel"] + g1,
             ice=s["ice"] + i1)
    return s, w


def icloud(nml: PhysicsConfig, consts, s, dts, rdts):
    """Ice-phase microphysics driver (reference microphysics.py:1471-1719):
    instant ice melt / homogeneous freezing, ice subgrid slope, then
    icloud_main + subgrid_z_proc."""
    c_air, c_vap = consts["c_air"], consts["c_vap"]
    qgz, qiz, qlz, qrz = s["qgz"], s["qiz"], s["qlz"], s["qrz"]
    qsz, qvz, tz = s["qsz"], s["qvz"], s["tz"]
    den, denfac = s["den"], s["denfac"]
    t_wfr = consts["t_wfr"]

    lhi = con.LI00 + con.DC_ICE * tz
    q_liq = qlz + qrz
    q_sol = qiz + qsz + qgz
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    icpk = lhi / cvm

    # instant melting of cloud ice
    mm = (tz > nml.tice) & (qiz > QCMIN)
    melt = minimum(qiz, consts["fac_imlt"] * (tz - nml.tice) / icpk)
    tmp = minimum(melt, _dim(nml.ql_mlt, qlz))
    qlz = _w(mm, qlz + tmp, qlz)
    qrz = _w(mm, qrz + melt - tmp, qrz)
    qiz = _w(mm, qiz - melt, qiz)
    q_liq = _w(mm, q_liq + melt, q_liq)
    q_sol = _w(mm, q_sol - melt, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mm, tz - melt * lhi / cvm, tz)

    # homogeneous freezing of cloud water into cloud ice
    mf = (~mm) & (tz < t_wfr) & (qlz > QCMIN)
    dtmp = t_wfr - tz
    factor = minimum(1.0, dtmp / DT_FR)
    sink = minimum(qlz * factor, dtmp / icpk)
    qi_crt = nml.qi_gen * minimum(nml.qi_lim, 0.1 * (nml.tice - tz)) / den
    tmp = minimum(sink, _dim(qi_crt, qiz))
    qlz = _w(mf, qlz - sink, qlz)
    qsz = _w(mf, qsz + sink - tmp, qsz)
    qiz = _w(mf, qiz + tmp, qiz)
    q_liq = _w(mf, q_liq - sink, q_liq)
    q_sol = _w(mf, q_sol + sink, q_sol)
    cvm = _cvm(c_air, c_vap, qvz, q_liq, q_sol)
    tz = _w(mf, tz + sink * lhi / cvm, tz)

    # vertical subgrid variability of cloud ice
    if nml.z_slope_ice:
        di = _z_slope(qiz, s["h_var"])
    else:
        di = maximum(QVMIN, s["h_var"] * qiz)

    qaz, qgz, qiz, qlz, qrz, qsz, qvz, tz = icloud_main(
        nml, consts, dts, rdts, s["h_var"], s["rh_adj"], s["rh_rain"],
        s["qaz"], qgz, qiz, qlz, qrz, qsz, qvz, tz, den, denfac,
        s["vtgz"], s["vtrz"], s["vtsz"], s["p1"], di, q_liq, q_sol, cvm,
    )
    s = dict(s)
    s.update(qaz=qaz, qgz=qgz, qiz=qiz, qlz=qlz, qrz=qrz, qsz=qsz, qvz=qvz,
             tz=tz)
    return s


def fields_update(nml: PhysicsConfig, consts, s, ntimes, rdt):
    """Sedimentation momentum transport and tendency updates (reference
    microphysics.py:1719-1852).  Returns the tendency/precip dict."""
    m1, dp0 = s["m1"], s["dp0"]
    u1, v1 = s["u1"], s["v1"]
    if nml.sedi_transport:
        u_l, v_l, m1_l, dp_l = _levels(u1, v1, m1, dp0)
        u_prev, v_prev, m1_prev = u_l[0], v_l[0], m1_l[0]
        us, vs = [u_prev], [v_prev]
        for u_k, v_k, m1_k, dp_k in zip(u_l[1:], v_l[1:], m1_l[1:],
                                        dp_l[1:]):
            u_prev = (dp_k * u_k + m1_prev * u_prev) / (dp_k + m1_prev)
            v_prev = (dp_k * v_k + m1_prev * v_prev) / (dp_k + m1_prev)
            m1_prev = m1_k
            us.append(u_prev)
            vs.append(v_prev)
        u1 = torch.stack(us, -1)
        v1 = torch.stack(vs, -1)
        zero_top = torch.zeros_like(u1[..., :1])
        udt = torch.cat(
            [zero_top, (u1[..., 1:] - s["u0"][..., 1:]) * rdt], -1
        )
        vdt = torch.cat(
            [zero_top, (v1[..., 1:] - s["v0"][..., 1:]) * rdt], -1
        )
    else:
        udt = torch.zeros_like(u1)
        vdt = torch.zeros_like(v1)

    omq = s["dp1"] / dp0
    qv_dt = rdt * (s["qvz"] - s["qv0"]) * omq
    ql_dt = rdt * (s["qlz"] - s["ql0"]) * omq
    qr_dt = rdt * (s["qrz"] - s["qr0"]) * omq
    qi_dt = s["qi_dt"] + rdt * (s["qiz"] - s["qi0"]) * omq
    qs_dt = s["qs_dt"] + rdt * (s["qsz"] - s["qs0"]) * omq
    qg_dt = rdt * (s["qgz"] - s["qg0"]) * omq
    cvm = _cvm(consts["c_air"], consts["c_vap"], s["qvz"],
               s["qrz"] + s["qlz"], s["qiz"] + s["qsz"] + s["qgz"])
    pt_dt = rdt * (s["tz"] - s["t0"]) * cvm / con.CP_AIR
    if nml.do_qa:
        qa_dt = torch.zeros_like(qv_dt)
    else:
        qa_dt = rdt * (s["qaz"] / ntimes - s["qa0"])

    convt = 86400.0 * rdt * con.RGRAV
    return dict(
        qv_dt=qv_dt, ql_dt=ql_dt, qr_dt=qr_dt, qi_dt=qi_dt, qs_dt=qs_dt,
        qg_dt=qg_dt, qa_dt=qa_dt, pt_dt=pt_dt, udt=udt, vdt=vdt,
        rain=s["rain"] * convt, snow=s["snow"] * convt,
        ice=s["ice"] * convt, graupel=s["graupel"] * convt,
        u1=u1, v1=v1,
    )


# --- scheme constants (setupm; reference microphysics.py:2092-2280) ----------


def setup_microphysics_constants(nml: PhysicsConfig, timestep: float) -> dict:
    gam263, gam275, gam290 = 1.456943, 1.608355, 1.827363
    gam325, gam350, gam380 = 2.54925, 3.323363, 4.694155
    rnzs, rnzr, rnzg = 3.0e6, 8.0e6, 4.0e6
    acc = np.array([5.0, 2.0, 0.5])
    pie = float(4.0 * np.arctan(1.0))
    fac_rc = (4.0 / 3.0) * pie * RHOR * nml.rthresh ** 3
    vdifu, tcond = 2.11e-5, 2.36e-2
    visk = 1.259e-5
    hlts, hltc, hltf = 2.8336e6, 2.5e6, 3.336e5
    ch2o = 4.1855e3
    pisq = pie * pie
    scm3 = (visk / vdifu) ** (1.0 / 3.0)

    cracs = pisq * rnzr * rnzs * RHOS
    csacr = pisq * rnzr * rnzs * RHOR
    cgacr = pisq * rnzr * rnzg * RHOR
    cgacs = pisq * rnzg * rnzs * RHOS * nml.c_pgacs

    act = np.empty(8)
    act[0] = pie * rnzs * RHOS
    act[1] = pie * rnzr * RHOR
    act[5] = pie * rnzg * RHOG
    act[2] = act[1]
    act[3] = act[0]
    act[4] = act[1]
    act[6] = act[0]
    act[7] = act[5]
    acco = [
        [
            float(acc[i] / (act[2 * k] ** ((6 - i) * 0.25)
                            * act[2 * k + 1] ** ((i + 1) * 0.25)))
            for k in range(4)
        ]
        for i in range(3)
    ]

    gcon = 40.74 * np.sqrt(SFCRHO)
    csacw = pie * rnzs * nml.clin * gam325 / (4.0 * act[0] ** 0.8125)
    craci = pie * rnzr * nml.alin * gam380 / (4.0 * act[1] ** 0.95)
    csaci = csacw * nml.c_psaci
    cgacw = pie * rnzg * gam350 * gcon / (4.0 * act[5] ** 0.875)
    cgaci = cgacw * 0.05
    cracw = nml.c_cracw * craci

    cssub = (
        2.0 * pie * vdifu * tcond * con.RVGAS * rnzs,
        0.78 / np.sqrt(act[0]),
        0.31 * scm3 * gam263 * np.sqrt(nml.clin / visk) / act[0] ** 0.65625,
        tcond * con.RVGAS,
        hlts ** 2 * vdifu,
    )
    cgsub = (
        2.0 * pie * vdifu * tcond * con.RVGAS * rnzg,
        0.78 / np.sqrt(act[5]),
        0.31 * scm3 * gam275 * np.sqrt(gcon / visk) / act[5] ** 0.6875,
        cssub[3],
        cssub[4],
    )
    crevp = (
        2.0 * pie * vdifu * tcond * con.RVGAS * rnzr,
        0.78 / np.sqrt(act[1]),
        0.31 * scm3 * gam290 * np.sqrt(nml.alin / visk) / act[1] ** 0.725,
        cssub[3],
        hltc ** 2 * vdifu,
    )
    cgfr = (20.0e2 * pisq * rnzr * RHOR / act[1] ** 1.75, 0.66)
    csmlt = (
        2.0 * pie * tcond * rnzs / hltf,
        2.0 * pie * vdifu * rnzs * hltc / hltf,
        cssub[1], cssub[2], ch2o / hltf,
    )
    cgmlt = (
        2.0 * pie * tcond * rnzg / hltf,
        2.0 * pie * vdifu * rnzg * hltc / hltf,
        cgsub[1], cgsub[2], ch2o / hltf,
    )
    es0 = 6.107799961e2

    c_air = con.CP_AIR
    c_vap = con.CP_VAP
    d0_vap = c_vap - con.C_LIQ
    lv00 = con.HLV - d0_vap * con.TICE
    cpaut = nml.c_paut * 0.104 * con.GRAV / 1.717e-5

    # sub-timestep factors (reference _set_timestep, 2234-2248)
    mpdt = min(timestep, nml.mp_time)
    rdt = 1.0 / timestep
    ntimes = int(round(timestep / mpdt))
    dts = timestep / ntimes
    dt_rain = dts * 0.5
    rdts = 1.0 / dts
    dt_evap = 0.5 * dts if nml.fast_sat_adj else dts
    return dict(
        cracs=float(cracs), csacr=float(csacr), cgacr=float(cgacr),
        cgacs=float(cgacs), acco=acco, csacw=float(csacw),
        csaci=float(csaci), cgacw=float(cgacw), cgaci=float(cgaci),
        cracw=float(cracw),
        cssub=tuple(map(float, cssub)), cgsub=tuple(map(float, cgsub)),
        crevp=tuple(map(float, crevp)), cgfr=tuple(map(float, cgfr)),
        csmlt=tuple(map(float, csmlt)), cgmlt=tuple(map(float, cgmlt)),
        ces0=float(con.EPS * es0), fac_rc=float(fac_rc),
        c_air=float(c_air), c_vap=float(c_vap), d0_vap=float(d0_vap),
        lv00=float(lv00), cpaut=float(cpaut),
        t_wfr=float(nml.tice - 40.0), tice0=float(nml.tice - 0.01),
        log_10=float(np.log(10.0)),
        ntimes=ntimes, dts=float(dts), dt_rain=float(dt_rain),
        rdts=float(rdts), rdt=float(rdt),
        fac_i2s=float(1.0 - np.exp(-dts / nml.tau_i2s)),
        fac_g2v=float(1.0 - np.exp(-dts / nml.tau_g2v)),
        fac_v2g=float(1.0 - np.exp(-dts / nml.tau_v2g)),
        fac_imlt=float(1.0 - np.exp(-0.5 * dts / nml.tau_imlt)),
        fac_l2v=float(1.0 - np.exp(-dt_evap / nml.tau_l2v)),
    )


# --- top-level driver -------------------------------------------------------


@dataclasses.dataclass
class MicrophysicsState:
    """Microphysics inputs (API analogue of the reference
    MicrophysicsState, microphysics.py:1855-1894): tensors of shape
    (..., nz) [3D] or (...,) [2D] on one device."""
    pt: torch.Tensor
    qvapor: torch.Tensor
    qliquid: torch.Tensor
    qrain: torch.Tensor
    qice: torch.Tensor
    qsnow: torch.Tensor
    qgraupel: torch.Tensor
    qcld: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    delp: torch.Tensor
    delz: torch.Tensor
    omga: torch.Tensor
    delprsi: torch.Tensor  # pressure thickness for the physics (moist)
    wmp: torch.Tensor  # vertical motion for the microphysics
    dz: torch.Tensor
    land: torch.Tensor  # 2D land fraction
    qi_dt: torch.Tensor = None
    qs_dt: torch.Tensor = None

    @classmethod
    def from_numpy(cls, arrays: dict, device, dtype) -> "MicrophysicsState":
        """Build from numpy arrays keyed by the field names of
        `pace_tpu`'s MicrophysicsState (qi_dt and qs_dt may be absent or
        None)."""
        return cls(**{
            f.name: torch.tensor(np.asarray(arrays[f.name]), dtype=dtype,
                                 device=device)
            for f in dataclasses.fields(cls)
            if arrays.get(f.name) is not None
        })


class Microphysics:
    """GFDL cloud microphysics driver on `device` (the card unless the
    caller asks for the CPU).

    `__call__(state)` returns the tendency dict.  All scheme constants are
    Python floats fixed at construction."""

    def __init__(self, config: PhysicsConfig, area, timestep: float,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        # 2D cell areas (m^2), same layout as the fields
        self.area = area.to(self.device)
        self.timestep = timestep
        self.consts = setup_microphysics_constants(config, timestep)

    def __call__(self, state: MicrophysicsState):
        nml, c = self.config, self.consts
        if state.pt.device.type != self.device.type:
            raise ValueError(
                f"state on {state.pt.device}, microphysics on {self.device}")
        qn = torch.zeros_like(state.pt)
        qi_dt = state.qi_dt if state.qi_dt is not None else torch.zeros_like(
            state.pt
        )
        qs_dt = state.qs_dt if state.qs_dt is not None else torch.zeros_like(
            state.pt
        )
        s = fields_init(
            nml, c, state.land, self.area, state.qcld, state.qgraupel,
            state.qice, state.qliquid, qn, state.qrain, state.qsnow,
            state.qvapor, state.pt, state.delprsi, state.dz, qi_dt, qs_dt,
            state.ua, state.va, self.timestep, c["rdt"],
        )
        w = state.wmp
        for _ in range(c["ntimes"]):
            s, w = warm_rain(nml, c, s, w, c["dt_rain"], is_first=True)
            s, w = sedimentation(nml, c, s, w, c["dts"])
            s, w = warm_rain(nml, c, s, w, c["dt_rain"], is_first=False)
            s = icloud(nml, c, s, c["dts"], c["rdts"])
        out = fields_update(nml, c, s, c["ntimes"], c["rdt"])
        out["wmp"] = w
        return out
