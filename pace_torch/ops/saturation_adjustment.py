"""Fast saturation adjustment (SatAdjust3d): grid-scale phase changes.

Port of `pace_tpu.ops.saturation_adjustment` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/saturation_adjustment.py; Zhou, Harris and
Chen 2022).  As in `pace_tpu`, the saturation vapour pressure and its
temperature derivative are the closed forms the reference's 2621-entry
tables were built from, evaluated at the table-clamped temperature
(`_es_and_ddt`); `qs_tables` builds the tables themselves in numpy, for
the QSInit savepoint.  Everything is elementwise over (6, N, N, nz)
tensors; the time-scale factors are Python floats fixed per call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pace_torch.ops.stencil_utils import dim, maximum, minimum
from pace_torch.utils import constants

DELT = 0.1
QS_LENGTH = 2621


def qs_tables():
    """The reference's saturation tables (table, table2, tablew, des2,
    desw), float64 numpy, as `pace_tpu.ops.saturation_adjustment._qs_tables`
    builds them."""
    i = np.arange(QS_LENGTH, dtype=np.float64)
    tem_l = constants.T_SAT_MIN + DELT * i
    tem_u = 253.16 + DELT * (i - 1400)

    def q_table(dc, lh, tem):
        return constants.E00 * np.exp(
            (dc * np.log(tem / constants.TICE)
             + (tem - constants.TICE) / (tem * constants.TICE) * lh)
            / constants.RVGAS
        )

    t_ice_l = q_table(constants.D2ICE, constants.LI2, tem_l)
    t_vap_l = q_table(constants.DC_VAP, constants.LV0, tem_l)
    t_vap_u = q_table(constants.DC_VAP, constants.LV0, tem_u)

    table = np.where(i < 1600, t_ice_l, t_vap_u)
    blend = (i >= 1400) & (i < 1600)
    wice = 0.05 * (constants.TICE - tem_u)
    wh2o = 0.05 * (tem_u - 253.16)
    table = np.where(blend, wice * t_ice_l + wh2o * t_vap_u, table)

    table2 = np.where(i < 1600, t_ice_l, t_vap_l)
    # smoothing at the ice/water transition
    for idx in (1599, 1600):
        table2[idx] = 0.25 * (table2[idx - 1] + 2.0 * table[idx]
                              + table2[idx + 1])

    def des(t):
        d = np.maximum(0.0, np.diff(t, append=t[-1]))
        d[-1] = d[-2]
        return d

    return table, table2, t_vap_l, des(table2), des(t_vap_l)


def _es_water(t):
    return constants.E00 * torch.exp(
        (constants.DC_VAP * torch.log(t / constants.TICE)
         + constants.LV0 * (t - constants.TICE) / (t * constants.TICE))
        / constants.RVGAS
    )


def _es_ice(t):
    return constants.E00 * torch.exp(
        (constants.D2ICE * torch.log(t / constants.TICE)
         + constants.LI2 * (t - constants.TICE) / (t * constants.TICE))
        / constants.RVGAS
    )


def _es_and_ddt(ta, kind: str):
    """Saturation vapor pressure (and its temperature derivative) evaluated
    analytically at the table-clamped temperature.  "w" is the pure-water
    table (tablew); "i2" is table2: ice below TICE, water above (the two
    branches are continuous at TICE where both equal E00)."""
    t = torch.clamp(ta, constants.T_SAT_MIN,
                 constants.T_SAT_MIN + DELT * (QS_LENGTH - 1))
    if kind == "w":
        es = _es_water(t)
        desdt = es * (constants.DC_VAP + constants.LV0 / t) \
            / (constants.RVGAS * t)
    else:
        esw = _es_water(t)
        esi = _es_ice(t)
        ice = t < constants.TICE
        es = torch.where(ice, esi, esw)
        desdt = torch.where(
            ice,
            esi * (constants.D2ICE + constants.LI2 / t)
            / (constants.RVGAS * t),
            esw * (constants.DC_VAP + constants.LV0 / t)
            / (constants.RVGAS * t),
        )
    return es, desdt


def _wqs2(ta, den, kind: str):
    es, desdt = _es_and_ddt(ta, kind)
    denom = constants.RVGAS * ta * den
    return es / denom, desdt / denom


def _wqs1(tin, den, kind: str):
    es, _ = _es_and_ddt(tin, kind)
    return es / (constants.RVGAS * tin * den)


def _cvm_of(mc_air, qv, c_vap, q_liq, q_sol):
    return mc_air + qv * c_vap + q_liq * constants.C_LIQ \
        + q_sol * constants.C_ICE


def _lh_coeffs(pt1, cvm, lv00, d0_vap):
    lhl = lv00 + d0_vap * pt1
    lhi = constants.LI00 + constants.DC_ICE * pt1
    return lhl, lhi, lhl / cvm, lhi / cvm


def saturation_adjustment(
    dp1, tracers, hs, peln, delp, delz, q_con, pt, pkz, cappa, zvir, mdt,
    last_step, akap, gd, config, n, h, vp=None,
):
    """Returns (tracers, q_con, pt, pkz, cappa, delp, delz, peln)."""
    sdt = 0.5 * mdt
    fac_i2s = 1.0 - math.exp(-mdt / config.tau_i2s)
    fac_v2l = 1.0 - math.exp(-sdt / config.tau_v2l)
    fac_r2g = 1.0 - math.exp(-mdt / config.tau_r2g)
    fac_l2r = 1.0 - math.exp(-mdt / config.tau_l2r)
    fac_l2v = min(config.sat_adj0, 1.0 - math.exp(-sdt / config.tau_l2v))
    fac_imlt = 1.0 - math.exp(-sdt / config.tau_imlt)
    fac_smlt = 1.0 - math.exp(-mdt / config.tau_smlt)
    c_air = constants.CV_AIR
    c_vap = constants.CV_VAP
    d0_vap = c_vap - constants.C_LIQ
    lv00 = constants.HLV - d0_vap * constants.TICE

    qv0, ql0 = tracers["qvapor"], tracers["qliquid"]
    qi0, qr0 = tracers["qice"], tracers["qrain"]
    qs0, qg0 = tracers["qsnow"], tracers["qgraupel"]
    qa0 = tracers["qcld"]
    pt0, cappa0, pkz0, qcon0 = pt, cappa, pkz, q_con

    qv, ql, qi, qr, qs, qg = qv0, ql0, qi0, qr0, qs0, qg0

    q_liq = ql + qr
    q_sol = qi + qs + qg
    qpz = q_liq + q_sol
    pt1 = pt / ((1.0 + zvir * qv) * (1.0 - qpz))
    qpz = qpz + qv
    den = -delp / (constants.GRAV * delz)
    mc_air = (1.0 - qpz) * c_air
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    lhi = constants.LI00 + constants.DC_ICE * pt1
    icp2 = lhi / cvm

    # fix negative cloud ice with snow
    qs = torch.where(qi < 0.0, qs + qi, qs)
    qi = maximum(qi, 0.0)

    # melt cloud ice
    melt = torch.logical_and(qi > 1.0e-8, pt1 > constants.TICE)
    sink = torch.where(
        melt, minimum(qi, fac_imlt * (pt1 - constants.TICE) / icp2), 0.0
    )
    qi = qi - sink
    ql = ql + sink
    q_liq = q_liq + sink
    q_sol = q_sol - sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 - sink * lhi / cvm

    lhi = constants.LI00 + constants.DC_ICE * pt1
    icp2 = lhi / cvm
    # fix negative snow with graupel
    qg_n = torch.where(qs < 0.0, qg + qs, qg)
    qs_n = torch.where(qs < 0.0, 0.0, qs)
    tmp = minimum(-qg_n, maximum(qs_n, 0.0))
    fix2 = torch.logical_and(qs >= 0.0, qg < 0.0)
    qg = torch.where(fix2, qg_n + tmp, qg_n)
    qs = torch.where(fix2, qs_n - tmp, qs_n)
    # fix negative cloud water with rain
    tmp_l = minimum(-ql, maximum(qr, 0.0))
    tmp_r = minimum(-qr, maximum(ql, 0.0))
    neg_l = ql < 0.0
    neg_r = torch.logical_and(ql >= 0.0, qr < 0.0)
    ql = torch.where(neg_l, ql + tmp_l, torch.where(neg_r, ql - tmp_r, ql))
    qr = torch.where(neg_l, qr - tmp_l, torch.where(neg_r, qr + tmp_r, qr))

    # complete freezing below -48C
    dtmp = constants.TICE - 48.0 - pt1
    do_frz = torch.logical_and(ql > 0.0, dtmp > 0.0)
    sink = torch.where(do_frz, minimum(ql, dtmp / icp2), 0.0)
    ql = ql - sink
    qi = qi + sink
    q_liq = q_liq - sink
    q_sol = q_sol + sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + sink * lhi / cvm

    wqsat, dq2dt = _wqs2(pt1, den, "w")
    lhl, lhi, lcp2, icp2 = _lh_coeffs(pt1, cvm, lv00, d0_vap)
    tcp3 = lcp2 + icp2 * minimum(1.0, dim(constants.TICE, pt1) / 48.0)
    dq0 = (qv - wqsat) / (1.0 + tcp3 * dq2dt)
    src_pos = minimum(
        config.sat_adj0 * dq0,
        maximum(config.ql_gen - ql, fac_v2l * dq0),
    )
    factor = -minimum(1.0, fac_l2v * 10.0 * (1.0 - qv / wqsat))
    src_neg = -minimum(ql, factor * dq0)
    src = torch.where(dq0 > 0.0, src_pos, src_neg)
    qv = qv - src
    ql = ql + src
    q_liq = q_liq + src
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + src * lhl / cvm

    lhl, lhi, lcp2, icp2 = _lh_coeffs(pt1, cvm, lv00, d0_vap)
    tcp3 = lcp2 + icp2 * minimum(1.0, dim(constants.TICE, pt1) / 48.0)

    if last_step:
        wqsat, dq2dt = _wqs2(pt1, den, "w")
        dq0 = (qv - wqsat) / (1.0 + tcp3 * dq2dt)
        factor = -minimum(1.0, fac_l2v * 10.0 * (1.0 - qv / wqsat))
        src = torch.where(dq0 > 0.0, dq0, -minimum(ql, factor * dq0))
        qv = qv - src
        ql = ql + src
        q_liq = q_liq + src
        cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
        pt1 = pt1 + src * lhl / cvm
        lhl, lhi, lcp2, icp2 = _lh_coeffs(pt1, cvm, lv00, d0_vap)

    # homogeneous freezing [-48, -40]
    dtmp = constants.T_WFR - pt1
    do_frz = torch.logical_and(ql > 0.0, dtmp > 0.0)
    sink = minimum(minimum(ql, dtmp / icp2), ql * dtmp * 0.125)
    sink = torch.where(do_frz, sink, 0.0)
    ql = ql - sink
    qi = qi + sink
    q_liq = q_liq - sink
    q_sol = q_sol + sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + sink * lhi / cvm

    lhi = constants.LI00 + constants.DC_ICE * pt1
    icp2 = lhi / cvm
    # Bigg heterogeneous freezing
    exptc = torch.exp(0.66 * (constants.TICE0 - pt1))
    tc = constants.TICE0 - pt1
    do_frz = torch.logical_and(ql > 0.0, tc > 0.0)
    sink = 3.3333e-10 * mdt * (exptc - 1.0) * den * ql ** 2
    sink = minimum(minimum(ql, sink), tc / icp2)
    sink = torch.where(do_frz, sink, 0.0)
    ql = ql - sink
    qi = qi + sink
    q_liq = q_liq - sink
    q_sol = q_sol + sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + sink * lhi / cvm

    lhi = constants.LI00 + constants.DC_ICE * pt1
    icp2 = lhi / cvm
    # rain to graupel
    dtmp = (constants.TICE - 0.1) - pt1
    do_g = torch.logical_and(qr > 1e-7, dtmp > 0.0)
    rainfac = (dtmp * 0.025) ** 2
    tmp = torch.where(rainfac > 1.0, qr, rainfac * qr)
    sink = torch.where(do_g, minimum(tmp, fac_r2g * dtmp / icp2), 0.0)
    qr = qr - sink
    qg = qg + sink
    q_liq = q_liq - sink
    q_sol = q_sol + sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + sink * lhi / cvm

    lhi = constants.LI00 + constants.DC_ICE * pt1
    icp2 = lhi / cvm
    # snow melt
    dtmp = pt1 - (constants.TICE + 0.1)
    do_m = torch.logical_and(qs > 1e-7, dtmp > 0.0)
    snowfac = (dtmp * 0.1) ** 2
    tmp = torch.where(snowfac > 1.0, qs, snowfac * qs)
    sink = torch.where(do_m, minimum(tmp, fac_smlt * dtmp / icp2), 0.0)
    tmp = minimum(sink, dim(config.qs_mlt, ql))
    qs = qs - sink
    ql = ql + tmp
    qr = qr + sink - tmp
    q_liq = q_liq + sink
    q_sol = q_sol - sink
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 - sink * lhi / cvm

    # autoconversion cloud -> rain
    over = maximum(ql - config.ql0_max, 0.0)
    sink = fac_l2r * over
    qr = qr + sink
    ql = ql - sink

    iqs2, dqsdt = _wqs2(pt1, den, "i2")
    expsubl = torch.exp(0.875 * torch.log(maximum(qi * den, 1e-30)))
    lhl, lhi, lcp2, icp2 = _lh_coeffs(pt1, cvm, lv00, d0_vap)
    tcp2 = lcp2 + icp2
    adj_fac = 1.0 if last_step else config.sat_adj0

    # sublimation / deposition of cloud ice
    dq = qv - iqs2
    sink_s = adj_fac * dq / (1.0 + tcp2 * dqsdt)
    pidep = torch.where(
        qi > 1.0e-8,
        sdt * dq * 349138.78 * expsubl / (
            iqs2 * den * constants.LAT2
            / (0.0243 * constants.RVGAS * pt1 ** 2) + 4.42478e4
        ),
        0.0,
    )
    tmp_t = constants.TICE - pt1
    qi_crt = torch.where(
        config.qi_lim < 0.1 * tmp_t,
        config.qi_gen * config.qi_lim / den,
        config.qi_gen * 0.1 * tmp_t / den,
    )
    src_dep = minimum(
        minimum(sink_s, maximum(qi_crt - qi, pidep)), tmp_t / tcp2
    )
    dimtmp = dim(pt1, config.t_sub)
    pidep_l = torch.where(dimtmp * 0.2 > 1.0, pidep, pidep * dimtmp * 0.2)
    src_sub = maximum(maximum(pidep_l, sink_s), -qi)
    src = torch.where(
        pt1 < config.t_sub, dim(qv, 1e-6),
        torch.where(
            pt1 < constants.TICE0,
            torch.where(dq > 0.0, src_dep, src_sub),
            0.0,
        ),
    )
    qv = qv - src
    qi = qi + src
    q_sol = q_sol + src
    cvm = _cvm_of(mc_air, qv, c_vap, q_liq, q_sol)
    pt1 = pt1 + src * (lhl + lhi) / cvm

    q_con_new = q_liq + q_sol
    tmp_v = 1.0 + zvir * qv
    pt_new = pt1 * tmp_v * (1.0 - q_con_new)
    tmp_r = tmp_v * constants.RDGAS
    cappa_new = tmp_r / (tmp_r + cvm)

    # fix negative graupel with cloud ice
    mintmp = minimum(-qg, maximum(0.0, qi))
    neg_g = qg < 0.0
    qg = torch.where(neg_g, qg + mintmp, qg)
    qi = torch.where(neg_g, qi - mintmp, qi)
    # autoconversion ice -> snow
    qim = config.qi0_max / den
    sink = torch.where(qi > qim, fac_i2s * (qi - qim), 0.0)
    qi = qi - sink
    qs = qs + sink

    cvm = mc_air + (qv + q_liq + q_sol) * c_vap
    lhl, lhi, lcp2, icp2 = _lh_coeffs(pt1, cvm, lv00, d0_vap)

    # cloud fraction (do_qa, last_step only)
    qa = qa0
    if last_step and config.do_qa:
        q_sol_r = qi + qs + (qg if config.rad_graupel else 0.0) \
            if config.rad_snow else qi
        q_liq_r = ql + qr if config.rad_rain else ql
        q_cond = q_sol_r + q_liq_r
        tin = pt1 if config.tintqs else pt1 - (lcp2 * q_cond + icp2 * q_sol_r)
        wqs1 = _wqs1(tin, den, "w")
        iqs1 = _wqs1(tin, den, "i2")
        rqi = torch.where(
            q_cond > 1e-6, q_sol_r / torch.where(q_cond == 0, 1.0, q_cond),
            (constants.TICE - tin) / (constants.TICE - constants.T_WFR),
        )
        qstar = torch.where(
            tin < constants.T_WFR, iqs1,
            torch.where(
                tin >= constants.TICE, wqs1,
                rqi * iqs1 + (1.0 - rqi) * wqs1,
            ),
        )
        mindw = minimum(1.0, torch.abs(hs) / (10.0 * constants.GRAV))
        dw = config.dw_ocean + (config.dw_land - config.dw_ocean) * mindw
        area = gd.horizontal.area
        hvar = minimum(
            0.2, maximum(0.01, dw * (area ** 0.5 / 100.0e3) ** 0.5)
        )[..., None]
        rh = qpz / qstar
        dq = hvar * qpz
        q_plus = qpz + dq
        q_minus = qpz - dq
        if config.icloud_f == 2:
            qa_v = torch.where(
                qpz > qstar, 1.0,
                torch.where(
                    torch.logical_and(qstar < q_plus, q_cond > 1.0e-8),
                    minimum(1.0, ((q_plus - qstar) / dq) ** 2), 0.0,
                ),
            )
        else:
            if config.icloud_f == 0:
                qa_mid = (q_plus - qstar) / (dq + dq)
            else:
                qa_mid = (q_plus - qstar) / (2.0 * dq * (1.0 - q_cond))
            qa_in = torch.where(qstar < q_plus, qa_mid, 0.0)
            qa_in = torch.where(
                q_cond > 1.0e-8, maximum(config.cld_min, qa_in), qa_in
            )
            qa_in = minimum(1.0, qa_in)
            qa_v = torch.where(qstar < q_minus, 1.0, qa_in)
        qa = torch.where(
            torch.logical_and(rh > 0.75, qpz > 1.0e-8), qa_v, 0.0
        )

    pkz_new = torch.exp(
        cappa_new * torch.log(constants.RDG * delp / delz * pt_new)
    )

    # restrict the adjustment to k >= kmp (pfull > 10 hPa)
    if vp is not None:
        kmp = int(np.argmax(np.asarray(vp["pfull"]) > 10.0e2))
    else:
        kmp = 0
    nz = pt.shape[-1]
    kmask = (torch.arange(nz, device=pt.device) >= kmp).reshape(1, 1, 1, nz)

    def blend(new, old):
        return torch.where(kmask, new, old)

    out_tracers = dict(tracers)
    out_tracers.update(
        qvapor=blend(qv, qv0), qliquid=blend(ql, ql0), qice=blend(qi, qi0),
        qrain=blend(qr, qr0), qsnow=blend(qs, qs0), qgraupel=blend(qg, qg0),
        qcld=blend(qa, qa0),
    )
    return (
        out_tracers, blend(q_con_new, qcon0), blend(pt_new, pt0),
        blend(pkz_new, pkz0), blend(cappa_new, cappa0), delp, delz, peln,
    )
