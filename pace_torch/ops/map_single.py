"""Conservative vertical remapping (map_single).

Port of `pace_tpu.ops.map_single` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/map_single.py).  The reference's per-column
`lev` bookkeeping becomes a cumulative-integral form: with F(p) the
integral of the PPM reconstruction from the column top to pressure p, each
Eulerian layer mean is (F(pe2[k+1]) - F(pe2[k])) / dp2[k].  F at a target
interface is an exclusive prefix sum of whole-layer integrals plus one
partial-layer polynomial integral inside the source layer j[k] that holds
the interface; the prefix is carried as a compensated pair (hi from the
cumulative sum, lo from its accumulated rounding errors), as in the
reference package.  The layer quantities at j[k] are read with one gather
along k.
"""

from __future__ import annotations

import torch

from pace_torch.ops.remap_profile import remap_profile
from pace_torch.ops.stencil_utils import cumsum_k


def _source_layer(pe1, pe2):
    """j[k] = #{m in 1..nz-1 : pe1[m] <= pe2[k]} in [0, nz-1]: the source
    layer holding target interface k (pe1/pe2 (..., nz+1))."""
    interior = pe1[..., 1:-1]
    return (interior[..., None, :] <= pe2[..., :, None]).sum(-1)


def lagrangian_contributions_spaces(space_groups):
    """Remap coefficient stacks across order-equivalent coordinate spaces.

    space_groups: list of (pe1, pe2, a1, a2, a3, a4, dp1) where every
    (pe1, pe2) pair is a monotone transform of the first (e.g. pressure and
    log-pressure), so the source-layer index j is the same in all of them.
    a* are (T, ..., nz) stacks.  Returns one (T, ..., nz) result per space.
    """
    j = _source_layer(space_groups[0][0], space_groups[0][1])
    results = []
    for pe1, pe2, q4_1, q4_2, q4_3, q4_4, dp1 in space_groups:
        integ = dp1 * (q4_2 + 0.5 * (q4_3 - q4_2 + q4_4) - q4_4 / 3.0)
        z = torch.zeros_like(integ[..., :1])
        c_hi = torch.cat([z, cumsum_k(integ)], -1)
        err = (c_hi[..., 1:] - c_hi[..., :-1]) - integ
        c_lo = -torch.cat([z, cumsum_k(err)], -1)

        def at_j(x):
            idx = j.expand(x.shape[:-1] + j.shape[-1:])
            return torch.gather(x, -1, idx)

        p_l, dpl = at_j(pe1[..., :-1]), at_j(dp1)
        c2, delta, c4 = at_j(q4_2), at_j(q4_3 - q4_2), at_j(q4_4)
        f_hi, f_lo0 = at_j(c_hi[..., :-1]), at_j(c_lo[..., :-1])

        # partial integral inside layer j up to the target interface
        s = torch.clamp((pe2 - p_l) / dpl, 0.0, 1.0)
        partial = dpl * s * (c2 + 0.5 * (delta + c4) * s - c4 * (s * s) / 3.0)
        f_lo = f_lo0 + partial
        num = (f_hi[..., 1:] - f_hi[..., :-1]) + (f_lo[..., 1:] - f_lo[..., :-1])
        results.append(num / (pe2[..., 1:] - pe2[..., :-1]))
    return results


def map_single(q1, pe1, pe2, n, h, kord, mode, qs=None, qmin: float = 0.0):
    """Remap q1 from Lagrangian levels pe1 to Eulerian levels pe2."""
    return map_single_spaces([(pe1, pe2, [(q1, kord, mode, qs, qmin)])],
                             n, h)[0][0]


def map_single_spaces(space_groups, n, h):
    """Remap groups of fields across several order-equivalent coordinate
    spaces through one shared source-layer index.

    space_groups: list of (pe1, pe2, groups); groups is a list of
    (q_stack_or_field, kord, mode, qs, qmin).  Returns a list of
    per-space result lists matching the input ranks."""
    inputs, meta = [], []
    for pe1, pe2, groups in space_groups:
        dp1 = pe1[..., 1:] - pe1[..., :-1]
        coeffs, sizes, was_stacked = [], [], []
        for q, kord, mode, qs, qmin in groups:
            stacked = q.ndim != pe1.ndim
            q = q if stacked else q[None]
            qs_g = torch.zeros_like(q[0, ..., 0]) if qs is None else qs
            a = [remap_profile(qs_g, q[t], dp1, n, h, kord, mode, qmin)
                 for t in range(q.shape[0])]
            coeffs.append([torch.stack(c) for c in zip(*a)])
            sizes.append(q.shape[0])
            was_stacked.append(stacked)
        stacked_coeffs = [torch.cat(parts, 0) for parts in zip(*coeffs)]
        inputs.append((pe1, pe2, *stacked_coeffs, dp1))
        meta.append((sizes, was_stacked))
    outs = lagrangian_contributions_spaces(inputs)
    all_results = []
    for out, (sizes, was_stacked) in zip(outs, meta):
        results, start = [], 0
        for size, stacked in zip(sizes, was_stacked):
            r = out[start:start + size]
            results.append(r if stacked else r[0])
            start += size
        all_results.append(results)
    return all_results
