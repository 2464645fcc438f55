"""Piecewise-parabolic (PPM) advection fluxes along x and y.

Port of `pace_tpu.ops.xppm` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/xppm.py / yppm.py with the limiters of
ppm.py).  Both directions run on the (6, N, N, nz) layout; the y operator
is the x operator with the shift/line-update axis switched.

Supports ord in {5, 6, 7} (monotone PPM variants via the smt5 advection
mask) and >= 8 (non-monotone with the standard constraint; 9 and 10 run
the ord-8 limiter exactly as the reference package does).
"""

from __future__ import annotations

import torch

from pace_torch.ops import stencil_utils as su
from pace_torch.ops.stencil_utils import shift, sign

# volume-conserving cubic with 2nd derivative = 0 at end point (ppm.py)
C1 = -2.0 / 14.0
C2 = 11.0 / 14.0
C3 = 5.0 / 14.0
# PPM volume mean form
P1 = 7.0 / 12.0
P2 = -1.0 / 12.0
S11 = 11.0 / 14.0
S14 = 4.0 / 7.0
S15 = 3.0 / 14.0


def _ax_ops(axis: int):
    """(shift-along-axis, update-static-lines-along-axis) pair for the
    global (6, N, N, ...) layout."""
    if axis == 1:
        return (lambda q, d: shift(q, d)), su.upd_cols
    return (lambda q, d: shift(q, 0, d)), su.upd_rows


def pert_ppm_standard_constraint(a0, al, ar):
    da1 = al - ar
    da2 = da1 ** 2
    a6da = 3.0 * (al + ar) * da1
    ar_new = torch.where(a6da < -da2, -2.0 * al, ar)
    al_new = torch.where(a6da > da2, -2.0 * ar, al)
    cross = al * ar < 0.0
    al_out = torch.where(cross, al_new, 0.0)
    ar_out = torch.where(cross, ar_new, 0.0)
    return al_out, ar_out


def _compute_al(q, dxa, n, h, sh, upd):
    """PPM interface value; tile-edge one-sided variants at the 6 special
    interface lines (xppm.py compute_al)."""
    al = P1 * (sh(q, -1) + q) + P2 * (sh(q, -2) + sh(q, 1))
    cubic = C1 * sh(q, -2) + C2 * sh(q, -1) + C3 * q
    al = upd(al, cubic, h - 1, h + n - 1)
    edge = 0.5 * (
        (
            (2.0 * sh(dxa, -1) + sh(dxa, -2)) * sh(q, -1)
            - sh(dxa, -1) * sh(q, -2)
        ) / (sh(dxa, -2) + sh(dxa, -1))
        + (
            (2.0 * dxa + sh(dxa, 1)) * q - dxa * sh(q, 1)
        ) / (dxa + sh(dxa, 1))
    )
    al = upd(al, edge, h, h + n)
    cubic_rev = C3 * sh(q, -1) + C2 * q + C1 * sh(q, 1)
    return upd(al, cubic_rev, h + 1, h + n + 1)


def _fx1_fn(courant, br, b0, bl, sh):
    return torch.where(
        courant > 0.0,
        (1.0 - courant) * (sh(br, -1) - courant * sh(b0, -1)),
        (1.0 + courant) * (bl + courant * b0),
    )


def _dm_iord8plus(q, sh):
    xt = 0.25 * (sh(q, 1) - sh(q, -1))
    dqr = torch.maximum(torch.maximum(q, sh(q, -1)), sh(q, 1)) - q
    dql = q - torch.minimum(torch.minimum(q, sh(q, -1)), sh(q, 1))
    return sign(torch.minimum(torch.minimum(torch.abs(xt), dqr), dql), xt)


def _xt_dxa_edge_0(q, dxa, sh):
    xt = 0.5 * (
        ((2.0 * dxa + sh(dxa, -1)) * q - dxa * sh(q, -1))
        / (sh(dxa, -1) + dxa)
        + (
            (2.0 * sh(dxa, 1) + sh(dxa, 2)) * sh(q, 1)
            - sh(dxa, 1) * sh(q, 2)
        ) / (sh(dxa, 1) + sh(dxa, 2))
    )
    minq = torch.minimum(
        torch.minimum(torch.minimum(sh(q, -1), q), sh(q, 1)), sh(q, 2))
    maxq = torch.maximum(
        torch.maximum(torch.maximum(sh(q, -1), q), sh(q, 1)), sh(q, 2))
    return torch.minimum(torch.maximum(xt, minq), maxq)


def _xt_dxa_edge_1(q, dxa, sh):
    xt = 0.5 * (
        (
            (2.0 * sh(dxa, -1) + sh(dxa, -2)) * sh(q, -1)
            - sh(dxa, -1) * sh(q, -2)
        ) / (sh(dxa, -2) + sh(dxa, -1))
        + ((2.0 * dxa + sh(dxa, 1)) * q - dxa * sh(q, 1))
        / (dxa + sh(dxa, 1))
    )
    minq = torch.minimum(
        torch.minimum(torch.minimum(sh(q, -2), sh(q, -1)), q), sh(q, 1))
    maxq = torch.maximum(
        torch.maximum(torch.maximum(sh(q, -2), sh(q, -1)), q), sh(q, 1))
    return torch.minimum(torch.maximum(xt, minq), maxq)


def _compute_blbr_ord8plus(q, dxa, n, h, sh, upd, constraint_cols=None):
    dm = _dm_iord8plus(q, sh)
    al = 0.5 * (sh(q, -1) + q) + (1.0 / 3.0) * (sh(dm, -1) - dm)
    xt2 = 2.0 * dm
    bl = -1.0 * sign(torch.minimum(torch.abs(xt2), torch.abs(al - q)), xt2)
    br = sign(torch.minimum(torch.abs(xt2), torch.abs(sh(al, 1) - q)), xt2)

    # edge overrides (xppm.py bl_br_edges)
    dm_left = _dm_iord8plus(sh(q, -1), sh)
    dm_right = _dm_iord8plus(sh(q, 1), sh)
    al_ip1 = sh(al, 1)

    xt_bl = torch.zeros_like(q)
    xt_br = torch.zeros_like(q)
    # i_start - 1
    xt_bl = upd(xt_bl, S14 * dm_left + S11 * (sh(q, -1) - q) + q, h - 1)
    xt_br = upd(xt_br, _xt_dxa_edge_0(q, dxa, sh), h - 1)
    # i_start
    xt_bl = upd(xt_bl, _xt_dxa_edge_1(q, dxa, sh), h)
    xt_br = upd(xt_br, S15 * q + S11 * sh(q, 1) - S14 * dm_right, h)
    # i_start + 1
    xt_bl = upd(xt_bl, S15 * sh(q, -1) + S11 * q - S14 * dm, h + 1)
    xt_br = upd(xt_br, al_ip1, h + 1)
    # i_end - 1
    xt_bl = upd(xt_bl, al, h + n - 2)
    xt_br = upd(xt_br, S15 * sh(q, 1) + S11 * q + S14 * dm, h + n - 2)
    # i_end
    xt_bl = upd(xt_bl, S15 * q + S11 * sh(q, -1) + S14 * dm_left, h + n - 1)
    xt_br = upd(xt_br, _xt_dxa_edge_0(q, dxa, sh), h + n - 1)
    # i_end + 1
    xt_bl = upd(xt_bl, _xt_dxa_edge_1(q, dxa, sh), h + n)
    xt_br = upd(xt_br, S11 * (sh(q, 1) - q) - S14 * dm_right + q, h + n)

    edge_cols = (h - 1, h, h + 1, h + n - 2, h + n - 1, h + n)
    bl = upd(bl, xt_bl - q, *edge_cols)
    br = upd(br, xt_br - q, *edge_cols)
    if constraint_cols is None:
        constraint_cols = edge_cols
    bl_c, br_c = pert_ppm_standard_constraint(q, bl, br)
    return upd(bl, bl_c, *constraint_cols), upd(br, br_c, *constraint_cols)


def _flux_core(q, courant, dgrid, n, h, ord_, sh, upd):
    mord = abs(ord_)
    if mord < 8:
        al = _compute_al(q, dgrid, n, h, sh, upd)
        bl = al - q
        br = sh(al, 1) - q
        b0 = bl + br
        if mord == 5:
            smt5 = (bl * br < 0.0).to(q.dtype)
        else:
            smt5 = ((3.0 * torch.abs(b0)) < torch.abs(bl - br)).to(q.dtype)
        mask = torch.maximum(sh(smt5, -1), smt5)
        fx1 = _fx1_fn(courant, br, b0, bl, sh)
        return torch.where(
            courant > 0.0, sh(q, -1) + fx1 * mask, q + fx1 * mask
        )
    bl, br = _compute_blbr_ord8plus(q, dgrid, n, h, sh, upd)
    b0 = bl + br
    fx1 = _fx1_fn(courant, br, b0, bl, sh)
    return torch.where(courant > 0.0, sh(q, -1) + fx1, q + fx1)


def x_flux(q, courant, dxa, n, h, iord):
    """PPM flux of q across x-interfaces given interface courant numbers."""
    sh, upd = _ax_ops(1)
    return _flux_core(q, courant, dxa, n, h, iord, sh, upd)


def y_flux(q, courant, dya, n, h, jord):
    """PPM flux across y-interfaces: the x operator with the axis switched."""
    sh, upd = _ax_ops(2)
    return _flux_core(q, courant, dya, n, h, jord, sh, upd)
