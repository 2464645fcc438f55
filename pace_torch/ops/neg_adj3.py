"""Cross-species negative-tracer fixer with heat accounting (neg_adj3).

Port of `pace_tpu.ops.neg_adj3` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/neg_adj3.py
`AdjustNegativeTracerMixingRatio` (nonhydrostatic, check_negative=False).
"""

from __future__ import annotations

import torch

from pace_torch.utils import constants

D0_VAP = constants.CV_VAP - constants.C_LIQ
LV00 = constants.HLV - D0_VAP * constants.TICE


def _fix_neg_water(pt, qvapor, qliquid, qrain, qsnow, qice, qgraupel):
    q_liq = torch.clamp(qliquid + qrain, min=0.0)
    q_sol = torch.clamp(qice + qsnow, min=0.0)
    cpm = (
        (1.0 - (qvapor + q_liq + q_sol)) * constants.CV_AIR
        + qvapor * constants.CV_VAP
        + q_liq * constants.C_LIQ
        + q_sol * constants.C_ICE
    )
    lcpk = (LV00 + D0_VAP * pt) / cpm
    icpk = (constants.LI0 + constants.DC_ICE * pt) / cpm

    # --- fix_negative_ice ---------------------------------------------------
    qsum = qice + qsnow
    qice_n = torch.where(
        qsum > 0.0,
        torch.where(qice < 0.0, 0.0, torch.where(qsnow < 0.0, qsum, qice)),
        0.0,
    )
    qsnow_n = torch.where(
        qsum > 0.0,
        torch.where(qice < 0.0, qsum, torch.where(qsnow < 0.0, 0.0, qsnow)),
        0.0,
    )
    qgraupel_n = torch.where(qsum > 0.0, qgraupel, qgraupel + qsum)
    qice, qsnow, qgraupel = qice_n, qsnow_n, qgraupel_n
    # borrow snow -> graupel
    dq = torch.where(qgraupel < 0.0, torch.minimum(qsnow, -qgraupel), 0.0)
    qsnow = qsnow - dq
    qgraupel = qgraupel + dq
    # borrow ice -> graupel
    dq = torch.where(qgraupel < 0.0, torch.minimum(qice, -qgraupel), 0.0)
    qice = qice - dq
    qgraupel = qgraupel + dq
    # borrow rain (note: the reference debits qliquid here, matching its code)
    cond = torch.logical_and(qgraupel < 0.0, qrain > 0.0)
    dq = torch.where(cond, torch.minimum(qrain, -qgraupel), 0.0)
    qgraupel = qgraupel + dq
    qliquid = qliquid - dq
    pt = pt + dq * icpk
    # borrow cloud water (phase change)
    cond = torch.logical_and(qgraupel < 0.0, qliquid > 0.0)
    dq = torch.where(cond, torch.minimum(qliquid, -qgraupel), 0.0)
    qgraupel = qgraupel + dq
    qliquid = qliquid - dq
    pt = pt + dq * icpk
    # last resort: water vapor
    cond = torch.logical_and(qgraupel < 0.0, qvapor > 0.0)
    dq = torch.where(cond, torch.minimum(0.999 * qvapor, -qgraupel), 0.0)
    qgraupel = qgraupel + dq
    qvapor = qvapor - dq
    pt = pt + dq * (icpk + lcpk)

    # --- fix_negative_liq ----------------------------------------------------
    qsum = qliquid + qrain
    pos_qg = torch.clamp(qgraupel, min=0.0)
    pos_branch_qrain = torch.where(
        qrain < 0.0, 0.0, torch.where(qliquid < 0.0, qsum, qrain)
    )
    pos_branch_qliq = torch.where(
        qrain < 0.0, qsum, torch.where(qliquid < 0.0, 0.0, qliquid)
    )
    # negative-total branch
    qrain_tmp = qsum
    dq = torch.minimum(pos_qg, -qrain_tmp)
    qrain_tmp = qrain_tmp + dq
    qgraupel_nb = qgraupel - dq
    pt_nb = pt - dq * icpk
    cond = qrain < 0.0
    dq2 = torch.where(cond, torch.minimum(qice + qsnow, -qrain_tmp), 0.0)
    qrain_tmp2 = qrain_tmp + dq2
    dq1 = torch.minimum(dq2, qsnow)
    qsnow_nb = qsnow - dq1
    qice_nb = qice + dq1 - dq2
    pt_nb = pt_nb - dq2 * icpk
    qrain_nb = qrain_tmp2
    cond2 = torch.logical_and(qrain_nb < 0.0, qvapor > 0.0)
    dq3 = torch.where(cond2, torch.minimum(0.999 * qvapor, -qrain_nb), 0.0)
    qvapor_nb = qvapor - dq3
    qrain_nb = qrain_nb + dq3
    pt_nb = pt_nb + dq3 * lcpk

    neg_total = qsum <= 0.0
    qliquid = torch.where(neg_total, 0.0, pos_branch_qliq)
    qrain = torch.where(neg_total, qrain_nb, pos_branch_qrain)
    qgraupel = torch.where(neg_total, qgraupel_nb, qgraupel)
    qsnow = torch.where(neg_total, qsnow_nb, qsnow)
    qice = torch.where(neg_total, qice_nb, qice)
    qvapor = torch.where(neg_total, qvapor_nb, qvapor)
    pt = torch.where(neg_total, pt_nb, pt)
    return pt, qvapor, qliquid, qrain, qsnow, qice, qgraupel


def _fillq(q, dp):
    """Borrow from the column's positive total to fill negatives, paying back
    from positive layers bottom-up (neg_adj3.py fillq)."""
    nz = q.shape[-1]
    qk = list(q.unbind(-1))
    dpk = list(dp.unbind(-1))
    s1 = torch.where(q > 0.0, q * dp, 0.0).sum(-1)
    s2 = torch.zeros_like(s1)
    for k in range(nz - 1, -1, -1):
        borrow = torch.logical_and(qk[k] < 0.0, s1 >= 0.0)
        dq = torch.where(borrow, torch.minimum(s1, -qk[k] * dpk[k]), 0.0)
        s1 = s1 - dq
        s2 = s2 + dq
        qk[k] = qk[k] + dq / dpk[k]
    for k in range(nz - 1, -1, -1):
        payback = torch.logical_and(
            torch.logical_and(qk[k] > 0.0, s1 >= 1e-12), s2 > 0.0
        )
        dq = torch.where(payback, torch.minimum(s2, qk[k] * dpk[k]), 0.0)
        s2 = s2 - dq
        qk[k] = qk[k] - dq / dpk[k]
    return torch.stack(qk, -1)


def _fix_water_vapor_down(q, dp):
    nz = q.shape[-1]
    qk = list(q.unbind(-1))
    dpk = list(dp.unbind(-1))
    # top
    q1 = torch.where(qk[0] < 0.0, qk[1] + qk[0] * dpk[0] / dpk[1], qk[1])
    qk[0] = torch.clamp(qk[0], min=0.0)
    qk[1] = q1

    # forward pass k = 1..nz-2: borrow from above, push deficit below
    upper_fix = [torch.zeros_like(qk[0])] * nz
    q_prev, dp_prev = qk[0], dpk[0]
    low = torch.zeros_like(qk[0])
    for k in range(1, nz - 1):
        q_k, dp_k = qk[k], dpk[k]
        q_k = q_k + low / dp_k
        can_up = torch.logical_and(q_k < 0.0, q_prev > 0.0)
        dq = torch.where(
            can_up, torch.minimum(q_prev * dp_prev, -q_k * dp_k), 0.0
        )
        upper_fix[k] = dq
        q_k = q_k + dq / dp_k
        still_neg = q_k < 0.0
        low = torch.where(still_neg, q_k * dp_k, 0.0)
        q_k = torch.where(still_neg, 0.0, q_k)
        qk[k] = q_k
        q_prev, dp_prev = q_k, dp_k
    # account for borrows from above
    for k in range(nz - 1):
        qk[k] = qk[k] - upper_fix[k + 1] / dpk[k]
    # bottom: add any deficit pushed down from nz-2
    qbot = qk[nz - 1] + low / dpk[nz - 1]

    # redistribute bottom deficit from levels above (bottom-up)
    for k in range(nz - 2, -1, -1):
        need = torch.logical_and(qbot < 0.0, qk[k] > 0.0)
        dq = torch.where(
            need, torch.minimum(qk[k] * dpk[k], -qbot * dpk[nz - 1]), 0.0
        )
        qk[k] = qk[k] - dq / dpk[k]
        qbot = qbot + dq / dpk[nz - 1]
    qk[nz - 1] = qbot
    return torch.stack(qk, -1)


def _fix_neg_cloud(dp, q):
    nz = q.shape[-1]
    qk = list(q.unbind(-1))
    dpk = list(dp.unbind(-1))
    q_prev, dp_prev = qk[0], dpk[0]
    for k in range(1, nz - 1):
        q_k = torch.where(q_prev < 0.0, qk[k] + q_prev * dp_prev / dpk[k],
                          qk[k])
        q_prev, dp_prev = q_k, dpk[k]
        qk[k] = torch.clamp(q_k, min=0.0)
    # bottom fix
    need = torch.logical_and(qk[nz - 1] < 0.0, qk[nz - 2] > 0.0)
    dq = torch.where(
        need,
        torch.minimum(-qk[nz - 1] * dpk[nz - 1], qk[nz - 2] * dpk[nz - 2]),
        0.0,
    )
    q_nz2 = qk[nz - 2] - dq / dpk[nz - 2]
    qk[nz - 1] = torch.where(
        need, torch.clamp(qk[nz - 1] + dq / dpk[nz - 1], min=0.0), qk[nz - 1]
    )
    qk[nz - 2] = q_nz2
    return torch.stack(qk, -1)


def adjust_negative_tracers(tracers: dict, pt, delp):
    """Returns (tracers, pt)."""
    pt, qv, ql, qr, qs, qi, qg = _fix_neg_water(
        pt, tracers["qvapor"], tracers["qliquid"], tracers["qrain"],
        tracers["qsnow"], tracers["qice"], tracers["qgraupel"],
    )
    qg = _fillq(qg, delp)
    qr = _fillq(qr, delp)
    qv = _fix_water_vapor_down(qv, delp)
    qcld = _fix_neg_cloud(delp, tracers["qcld"])
    out = dict(tracers)
    out.update(
        qvapor=qv, qliquid=ql, qrain=qr, qsnow=qs, qice=qi, qgraupel=qg,
        qcld=qcld,
    )
    return out, pt
