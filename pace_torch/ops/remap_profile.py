"""Monotone cubic (PPM) vertical subgrid reconstruction (cs_profile).

Port of `pace_tpu.ops.remap_profile` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/remap_profile.py `RemapProfile`): cubic-spline
interface values via a vertical tridiagonal solve (a loop over k on whole
horizontal slabs), then kord/iv-dependent monotonicity constraints.

All tensors have k LAST: a4_1/delp (..., nz).  Returns (a4_1..a4_4).
kord: < 9, 9, 10; iv (mode): -2, -1, 0, 1, 2.  Other values raise.
"""

from __future__ import annotations

import torch

from pace_torch.ops.stencil_utils import upd_k


def _spline_interfaces(a1, delp, qs, iv):
    """Interface values by tridiagonal cubic spline (set_initial_vals).
    a1/delp (..., nz); qs (...). Returns q (..., nz+1)."""
    nz = a1.shape[-1]
    a = a1.unbind(-1)
    dp = delp.unbind(-1)
    if iv == -2:
        q0 = 1.5 * a[0]
        gam1 = torch.full_like(q0, 0.5)
        gr1 = dp[0] / dp[1]
        bet1 = 2.0 + gr1 + gr1 - gam1
        q1 = (3.0 * (a[0] + a[1]) - q0) / bet1
        q = [q0, q1]
        gam = [torch.zeros_like(q0), gam1]
        for k in range(2, nz):
            is_last = 1.0 if k == nz - 1 else 0.0
            old_gr = dp[k - 2] / dp[k - 1]
            old_bet = 2.0 + old_gr + old_gr - gam[k - 1]
            gam_k = old_gr / old_bet
            gr = dp[k - 1] / dp[k]
            bet = 2.0 + gr + gr - gam_k
            q.append((3.0 * (a[k - 1] + a[k]) - is_last * gr * qs - q[k - 1])
                     / bet)
            gam.append(gam_k)
        q.append(torch.broadcast_to(qs, q0.shape))
        # backward substitution k = nz-2..0 with gam_{k+1}
        for k in range(nz - 2, -1, -1):
            q[k] = q[k] - gam[k + 1] * q[k + 1]
        return torch.stack(q, -1)
    gr = dp[1] / dp[0]
    bet0 = gr * (gr + 0.5)
    q = [((gr + gr) * (gr + 1.0) * a[0] + a[1]) / bet0]
    gam = [(1.0 + gr * (gr + 1.5)) / bet0]
    for k in range(1, nz):
        d4 = dp[k - 1] / dp[k]
        bet = 2.0 + d4 + d4 - gam[k - 1]
        q.append((3.0 * (a[k - 1] + d4 * a[k]) - q[k - 1]) / bet)
        gam.append(d4 / bet)
    # bottom interface
    d4 = dp[nz - 2] / dp[nz - 1]
    a_bot = 1.0 + d4 * (d4 + 1.5)
    q.append((2.0 * d4 * (d4 + 1.0) * a[nz - 1] + a[nz - 2]
              - a_bot * q[nz - 1]) / (d4 * (d4 + 0.5) - a_bot * gam[nz - 1]))
    for k in range(nz - 1, -1, -1):
        q[k] = q[k] - gam[k] * q[k + 1]
    return torch.stack(q, -1)


def _minmax3(a, b, c):
    return (
        torch.minimum(torch.minimum(a, b), c),
        torch.maximum(torch.maximum(a, b), c),
    )


def _posdef_constraint_iv1(a1, a2, a3, a4):
    da1 = a3 - a2
    da2 = da1 * da1
    a6da = a4 * da1
    c0 = (a1 - a2) * (a1 - a3) >= 0.0
    c1 = a6da < -da2
    c2 = a6da > da2
    a2n = torch.where(c0, a1, torch.where(c1, a2, torch.where(c2, a3 - 3.0 * (a3 - a1), a2)))
    a3n = torch.where(c0, a1, torch.where(c1, a2 - 3.0 * (a2 - a1), torch.where(c2, a3, a3)))
    a4n = torch.where(c0, 0.0, torch.where(c1, 3.0 * (a2 - a1), torch.where(c2, 3.0 * (a3 - a1), a4)))
    return a2n, a3n, a4n


def _remap_constraint(a1, a2, a3, a4, extm):
    da1 = a3 - a2
    da2 = da1 * da1
    a6da = a4 * da1
    c1 = a6da < -da2
    c2 = a6da > da2
    a2n = torch.where(extm, a1, torch.where(c1, a2, torch.where(c2, a3 - 3.0 * (a3 - a1), a2)))
    a3n = torch.where(extm, a1, torch.where(c1, a2 - 3.0 * (a2 - a1), a3))
    a4n = torch.where(extm, 0.0, torch.where(c1, 3.0 * (a2 - a1), torch.where(c2, 3.0 * (a3 - a1), a4)))
    return a2n, a3n, a4n


def _posdef_constraint_iv0(a1, a2, a3, a4):
    neg = a1 <= 0.0
    trigger = torch.logical_and(
        torch.abs(a3 - a2) < -a4,
        (a1 + 0.25 * (a3 - a2) ** 2 / torch.where(a4 == 0, 1.0, a4)
         + a4 * (1.0 / 12.0)) < 0.0,
    )
    c_local_min = torch.logical_and(a1 < a3, a1 < a2)
    c_right = a3 > a2
    a2_t = torch.where(c_local_min, a1, torch.where(c_right, a2, a3 - 3.0 * (a3 - a1)))
    a3_t = torch.where(c_local_min, a1, torch.where(c_right, a2 - 3.0 * (a2 - a1), a3))
    a4_t = torch.where(c_local_min, 0.0, torch.where(c_right, 3.0 * (a2 - a1), 3.0 * (a3 - a1)))
    a2n = torch.where(neg, a1, torch.where(trigger, a2_t, a2))
    a3n = torch.where(neg, a1, torch.where(trigger, a3_t, a3))
    a4n = torch.where(neg, 0.0, torch.where(trigger, a4_t, a4))
    return a2n, a3n, a4n


def remap_profile(qs, a4_1, delp, n, h, kord: int, iv: int, qmin: float = 0.0):
    """Returns constrained (a4_1, a4_2, a4_3, a4_4) PPM coefficients."""
    if kord > 10:
        raise NotImplementedError(f"kord {kord}")
    if iv not in (-2, -1, 0, 1, 2):
        raise NotImplementedError(f"remap mode iv={iv}")
    nz = a4_1.shape[-1]
    q_if = _spline_interfaces(a4_1, delp, qs, iv)

    # --- apply_constraints ---------------------------------------------------
    # in k-last form; q_if (..., nz+1): every interface update is one
    # masked select over whole-column candidate expressions
    a1m = torch.cat([a4_1[..., :1], a4_1[..., :-1]], -1)  # a4_1[k-1]
    tmp = torch.maximum(a1m, a4_1)      # valid k >= 1
    tmp2 = torch.minimum(a1m, a4_1)
    gam_c = a4_1 - a1m                # gam[k] = a1[k]-a1[k-1], valid k >= 1
    q = q_if
    # layer-indexed bounds extended to interfaces: T_if[k] = tmp[k] for
    # k <= nz-1 and tmp[nz-1] at k = nz (the reference's bottom rule)
    tmp_if = torch.cat([tmp, tmp[..., -1:]], -1)
    tmp2_if = torch.cat([tmp2, tmp2[..., -1:]], -1)
    # gam at interface-relative offsets: GM[k] = gam_c[k-1], GP[k] = gam_c[k+1]
    # (clamped at the ends exactly as the slice+pad forms did)
    gm_if = torch.cat([gam_c[..., :1], gam_c], -1)
    gp_if = torch.cat(
        [gam_c[..., 1:], gam_c[..., -1:], gam_c[..., -1:]], -1
    )
    both = torch.clamp(q, tmp2_if, tmp_if)
    only_max = torch.maximum(q, tmp2_if)
    only_min = torch.minimum(q, tmp_if)
    if iv == 0:
        only_min = torch.clamp(only_min, min=0.0)
    sel = torch.where(
        gm_if * gp_if > 0.0, both,
        torch.where(gm_if > 0.0, only_max, only_min),
    )
    ki = torch.arange(nz + 1, device=q.device)
    q = torch.where(
        ki == 0, q,
        torch.where(torch.logical_or(ki == 1, ki == nz), both, sel),
    )

    a4_2 = q[..., :-1]
    a4_3 = q[..., 1:]

    # extrema flags
    extm_top = (a4_2 - a4_1) * (a4_3 - a4_1) > 0.0
    gam_prod = gam_c[..., 1:-1] * torch.cat(
        [gam_c[..., 2:], gam_c[..., -1:]], -1
    )[..., :nz - 2]
    extm = torch.cat(
        [extm_top[..., :1], gam_prod < 0.0, extm_top[..., -1:]], -1
    )
    x0 = 2.0 * a4_1 - (a4_2 + a4_3)
    x1 = torch.abs(a4_2 - a4_3)
    a4_4 = 3.0 * x0
    ext5 = torch.abs(x0) > x1
    ext6 = torch.abs(a4_4) > x1

    # --- set_interpolation_coefficients -------------------------------------
    # Each static-level update below writes level k of a whole-column
    # candidate expression; the constraint helpers are elementwise.
    kl = torch.arange(nz, device=a4_2.device)
    # top treatment (level 0)
    if iv == 0:
        a4_2 = upd_k(a4_2, torch.clamp(a4_2, min=0.0), 0)
    elif iv == -1:
        a4_2 = upd_k(a4_2, torch.where(a4_2 * a4_1 <= 0.0, 0.0, a4_2), 0)
    elif iv == 2:
        a4_2 = upd_k(a4_2, a4_1, 0)
        a4_3 = upd_k(a4_3, a4_1, 0)
        a4_4 = upd_k(a4_4, torch.zeros_like(a4_4), 0)
    a44_re = 3.0 * (2.0 * a4_1 - (a4_2 + a4_3))
    # iv = 2 keeps its flat top level and skips the positive-definite fix
    if iv == 2:
        a4_4 = upd_k(a4_4, a44_re, 1)
    else:
        a4_4 = upd_k(a4_4, a44_re, 0, 1)
        p2n, p3n, p4n = _posdef_constraint_iv1(a4_1, a4_2, a4_3, a4_4)
        a4_2n = upd_k(a4_2, p2n, 0)
        a4_3n = upd_k(a4_3, p3n, 0)
        a4_4n = upd_k(a4_4, p4n, 0)
        a4_2, a4_3, a4_4 = a4_2n, a4_3n, a4_4n
    r2n, r3n, r4n = _remap_constraint(a4_1, a4_2, a4_3, a4_4, extm)
    a4_2n = upd_k(a4_2, r2n, 1)
    a4_3n = upd_k(a4_3, r3n, 1)
    a4_4n = upd_k(a4_4, r4n, 1)
    a4_2, a4_3, a4_4 = a4_2n, a4_3n, a4_4n

    # interior layers k = 2..nz-3, computed whole-column and masked in
    interior = torch.logical_and(kl >= 2, kl <= nz - 3)
    gam = gam_c  # gam[k] = a1[k] - a1[k-1]
    g_p1 = torch.cat([gam[..., 1:], gam[..., -1:]], -1)      # gam[k+1]
    g_p2 = torch.cat([gam[..., 2:], gam[..., -2:]], -1)      # gam[k+2]
    g_m1 = torch.cat([gam[..., :1], gam[..., :-1]], -1)      # gam[k-1]
    a1i, a2i, a3i = a4_1, a4_2, a4_3
    if kord < 9:
        pmp_1 = a1i - g_p1
        lac_1 = pmp_1 + 1.5 * g_p2
        tmin, tmax = _minmax3(a1i, pmp_1, lac_1)
        a2n = torch.minimum(torch.maximum(a2i, tmin), tmax)
        pmp_2 = a1i + 2.0 * g_p1
        lac_2 = pmp_2 - 1.5 * g_m1
        tmin, tmax = _minmax3(a1i, pmp_2, lac_2)
        a3n = torch.minimum(torch.maximum(a3i, tmin), tmax)
        a4n = 3.0 * (2.0 * a1i - (a2n + a3n))
    elif kord == 9:
        pmp_1 = a1i - 2.0 * g_p1
        lac_1 = pmp_1 + 1.5 * g_p2
        pmp_2 = a1i + 2.0 * gam
        lac_2 = pmp_2 - 1.5 * g_m1
        e = extm
        e_m1 = torch.cat([extm[..., :1], extm[..., :-1]], -1)
        e_p1 = torch.cat([extm[..., 1:], extm[..., -1:]], -1)
        flat = torch.logical_and(e, torch.logical_or(e_m1, e_p1))
        if qmin > 0.0:
            flat = torch.logical_or(flat, torch.logical_and(e, a1i < qmin))
        a44_try = 6.0 * a1i - 3.0 * (a2i + a3i)
        limit = torch.abs(a44_try) > torch.abs(a2i - a3i)
        tmin1, tmax1 = _minmax3(a1i, pmp_1, lac_1)
        a2_lim = torch.minimum(torch.maximum(a2i, tmin1), tmax1)
        tmin2, tmax2 = _minmax3(a1i, pmp_2, lac_2)
        a3_lim = torch.minimum(torch.maximum(a3i, tmin2), tmax2)
        a2n = torch.where(flat, a1i, torch.where(limit, a2_lim, a2i))
        a3n = torch.where(flat, a1i, torch.where(limit, a3_lim, a3i))
        a4n = torch.where(
            flat, 0.0,
            torch.where(limit, 6.0 * a1i - 3.0 * (a2n + a3n), a44_try),
        )
    else:  # kord 10: limit where the cell or a neighbour is an extremum
        pmp_1 = a1i - 2.0 * g_p1
        lac_1 = pmp_1 + 1.5 * g_p2
        pmp_2 = a1i + 2.0 * gam
        lac_2 = pmp_2 - 1.5 * g_m1
        tmin2, tmax2 = _minmax3(a1i, pmp_1, lac_1)
        tmin3, tmax3 = _minmax3(a1i, pmp_2, lac_2)
        lim2 = torch.minimum(torch.maximum(a2i, tmin2), tmax2)
        lim3 = torch.minimum(torch.maximum(a3i, tmin3), tmax3)
        n5 = torch.logical_or(
            torch.cat([ext5[..., :1], ext5[..., :-1]], -1),
            torch.cat([ext5[..., 1:], ext5[..., -1:]], -1),
        )
        n6 = torch.logical_or(
            torch.cat([ext6[..., :1], ext6[..., :-1]], -1),
            torch.cat([ext6[..., 1:], ext6[..., -1:]], -1),
        )
        a2n = torch.where(
            ext5, torch.where(n5, a1i, torch.where(n6, lim2, a2i)),
            torch.where(torch.logical_and(ext6, n5), lim2, a2i),
        )
        a3n = torch.where(
            ext5, torch.where(n5, a1i, torch.where(n6, lim3, a3i)),
            torch.where(torch.logical_and(ext6, n5), lim3, a3i),
        )
        a4n = 3.0 * (2.0 * a1i - (a2n + a3n))
    if iv == 0:
        a2n, a3n, a4n = _posdef_constraint_iv0(a1i, a2n, a3n, a4n)
    a4_2 = torch.where(interior, a2n, a4_2)
    a4_3 = torch.where(interior, a3n, a4_3)
    a4_4 = torch.where(interior, a4n, a4_4)

    # bottom treatment (levels nz-2, nz-1)
    if iv == 0:
        a4_3 = upd_k(a4_3, torch.clamp(a4_3, min=0.0), nz - 1)
    elif iv == -1:
        a4_3 = upd_k(a4_3, torch.where(a4_3 * a4_1 <= 0.0, 0.0, a4_3),
                     nz - 1)
    a4_4 = upd_k(a4_4, 3.0 * (2.0 * a4_1 - (a4_2 + a4_3)), nz - 2, nz - 1)
    r2n, r3n, r4n = _remap_constraint(a4_1, a4_2, a4_3, a4_4, extm)
    a4_2n = upd_k(a4_2, r2n, nz - 2)
    a4_3n = upd_k(a4_3, r3n, nz - 2)
    a4_4n = upd_k(a4_4, r4n, nz - 2)
    a4_2, a4_3, a4_4 = a4_2n, a4_3n, a4_4n
    p2n, p3n, p4n = _posdef_constraint_iv1(a4_1, a4_2, a4_3, a4_4)
    a4_2 = upd_k(a4_2, p2n, nz - 1)
    a4_3 = upd_k(a4_3, p3n, nz - 1)
    a4_4 = upd_k(a4_4, p4n, nz - 1)
    return a4_1, a4_2, a4_3, a4_4
