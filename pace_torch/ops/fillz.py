"""Fix negative tracer values by borrowing mass vertically (fillz).

Port of `pace_tpu.ops.fillz` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/fillz.py `FillNegativeTracerValues`).
`fix_tracers` takes the stack of remapped tracers (T, 6, Ni, Nj, nz) with
one shared dp (6, Ni, Nj, nz): a CPU tensor runs the plain scan form
(`fix_tracer_plain`, a loop over k on whole horizontal slabs, per tracer),
a CUDA tensor one launch of the kernel of csrc/fillz.cu, which replaces
`pace_tpu.ops.pallas.fillz_pallas.fix_tracer_pallas`.
"""

from __future__ import annotations

import torch

from pace_torch.ops import bounds

# Launches of the CUDA fillz kernel; read and reset by chip_smoke.py.
LAUNCHES = 0


def fix_tracer_plain(q, dp):
    """q/dp (..., nz). Returns fixed q (the scan form)."""
    nz = q.shape[-1]
    qk = list(q.unbind(-1))
    dpk = list(dp.unbind(-1))
    zero = torch.zeros_like(qk[0])

    # fix_top
    q1 = torch.where(qk[0] < 0.0, qk[1] + qk[0] * dpk[0] / dpk[1], qk[1])
    q0 = torch.clamp(qk[0], min=0.0)
    qk[0], qk[1] = q0, q1

    # fix_interior: forward borrow k = 1..nz-2
    q_new = [q0] + [None] * (nz - 2) + [qk[nz - 1]]
    upper_fix = [zero] * nz
    lower_fix = [zero] * nz
    zfix = torch.zeros_like(qk[0], dtype=torch.bool)
    q_prev, dp_prev, low_prev = q0, dpk[0], zero
    for k in range(1, nz - 1):
        q_k, dp_k = qk[k], dpk[k]
        q_next_orig, dp_next = qk[k + 1], dpk[k + 1]
        q_k = torch.where(low_prev != 0.0, q_k - low_prev / dp_k, q_k)
        neg0 = q_k < 0.0
        can_up = torch.logical_and(neg0, q_prev > 0.0)
        dq_up = torch.minimum(q_prev * dp_prev, -(q_k * dp_k))
        q_k1 = torch.where(can_up, q_k + dq_up / dp_k, q_k)
        upper_fix[k] = torch.where(can_up, dq_up, 0.0)
        still_neg = torch.logical_and(q_k1 < 0.0, q_next_orig > 0.0)
        dq_lo = torch.minimum(q_next_orig * dp_next, -(q_k1 * dp_k))
        q_k2 = torch.where(still_neg, q_k1 + dq_lo / dp_k, q_k1)
        lower_fix[k] = torch.where(still_neg, dq_lo, 0.0)
        zfix = torch.logical_or(zfix, neg0)
        q_new[k] = q_k2
        q_prev, dp_prev, low_prev = q_k2, dp_k, lower_fix[k]

    # account for upward borrows: q_k -= upper_fix[k+1]/dp_k for k < nz-1
    for k in range(nz - 1):
        q_new[k] = q_new[k] - upper_fix[k + 1] / dpk[k]

    # fix_bottom
    q_bot = q_new[nz - 1]
    q_bot = torch.where(lower_fix[nz - 2] != 0.0,
                        q_bot - lower_fix[nz - 2] / dpk[nz - 1], q_bot)
    qup = q_new[nz - 2] * dpk[nz - 2]
    qly = -q_bot * dpk[nz - 1]
    dup = torch.minimum(qup, qly)
    bot_fix = torch.logical_and(q_bot < 0.0, q_new[nz - 2] > 0.0)
    q_bot = torch.where(bot_fix, q_bot + dup / dpk[nz - 1], q_bot)
    q_new[nz - 2] = torch.where(bot_fix, q_new[nz - 2] - dup / dpk[nz - 2],
                                q_new[nz - 2])
    q_new[nz - 1] = q_bot
    zfix = torch.logical_or(zfix, bot_fix)

    # positive-definite rescale of levels 1..nz-1; level 0 passes through
    qn = torch.stack(q_new, -1)
    dm = qn * dp
    sum0 = dm[..., 1:].sum(-1)
    sum1 = torch.clamp(dm[..., 1:], min=0.0).sum(-1)
    fac = torch.where(sum0 > 0.0,
                      sum0 / torch.where(sum1 == 0.0, 1.0, sum1), 0.0)
    apply = torch.logical_and(zfix, fac > 0.0)[..., None]
    q_final = torch.where(apply, torch.clamp(fac[..., None] * dm / dp,
                                             min=0.0), qn)
    return torch.cat([qn[..., :1], q_final[..., 1:]], -1)


def fix_tracers_cuda(q, dp):
    """The stacked fix as one launch of the CUDA kernel."""
    global LAUNCHES
    from pace_torch.ops import _cuda

    nz = q.shape[-1]
    if nz < 3:
        raise ValueError("the fillz kernel needs at least 3 levels")
    _cuda.check(q, shape=q.shape)
    _cuda.check(dp, shape=q.shape[1:], dtype=q.dtype)
    out = torch.empty_like(q)
    _cuda.launch("fillz", q.dtype, q, dp, out,
                 ints=(q.shape[0], dp.numel() // nz, nz))
    LAUNCHES += 1
    return out


def fix_tracers(q, dp):
    """Fix a (T, ..., nz) tracer stack sharing dp (..., nz).  A CPU tensor
    takes the plain version, a CUDA tensor the kernel."""
    with bounds.kernel_call("K-F") as report:
        if q.is_cuda:
            out = fix_tracers_cuda(q, dp)
        else:
            out = torch.stack([fix_tracer_plain(q[t], dp)
                               for t in range(q.shape[0])])
        report((q, dp), (out,), q.numel())
    return out
