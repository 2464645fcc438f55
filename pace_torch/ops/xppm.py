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

import functools

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


def _ax_ops(axis: int, dom):
    """(shift-along-axis, update-static-lines-along-axis) pair for the
    (tiles, Ni, Nj, ...) layout of `dom`."""
    if axis == 1:
        return (lambda q, d: shift(q, d)), functools.partial(su.upd_cols, dom)
    return (lambda q, d: shift(q, 0, d)), functools.partial(su.upd_rows, dom)


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


def _compute_al(q, dxa, dom, sh, upd):
    """PPM interface value; tile-edge one-sided variants at the 6 special
    interface lines (xppm.py compute_al)."""
    n, h = dom.n, dom.h
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


def _compute_blbr_ord8plus(q, dxa, dom, sh, upd, axis,
                           constraint_cols=None):
    """PPM edge perturbations bl, br for ord >= 8 along `axis`.  The
    one-sided edge forms (xppm.py bl_br_edges) and the standard constraint
    are evaluated on the columns they apply to only: each edge form reads
    the columns within 2 of its own, so it is evaluated on those 5 columns
    (the same operations on the same values as on the whole array; zeros
    past the block's bounds, as `shift` reads there).  A column the block
    does not hold is skipped."""
    n, h = dom.n, dom.h
    if h < 3:
        raise ValueError("the ord >= 8 edge forms need a halo of 3")
    dm = _dm_iord8plus(q, sh)
    al = 0.5 * (sh(q, -1) + q) + (1.0 / 3.0) * (sh(dm, -1) - dm)
    xt2 = 2.0 * dm
    bl = -1.0 * sign(torch.minimum(torch.abs(xt2), torch.abs(al - q)), xt2)
    br = sign(torch.minimum(torch.abs(xt2), torch.abs(sh(al, 1) - q)), xt2)
    size = q.shape[axis]

    def col(t, c):
        """Local column c of t, zeros outside the block."""
        if 0 <= c < size:
            return t.narrow(axis, c, 1)
        return torch.zeros_like(t.narrow(axis, 0, 1))

    def window(t, c):
        """The 5 local columns of t around c, zeros outside the block."""
        lo, hi = max(c - 2, 0), min(c + 3, size)
        part = t.narrow(axis, lo, hi - lo)
        if hi - lo == 5:
            return part
        pad = [torch.zeros_like(t.narrow(axis, 0, 1))]
        return torch.cat(pad * (lo - c + 2) + [part] + pad * (c + 3 - hi),
                         axis)

    def at(c, form):
        """form(w) at column c, w(t) the 5 columns of t around c."""
        return col(form(lambda t: window(t, c)), 2)

    def dm_left(w):
        return _dm_iord8plus(sh(w(q), -1), sh)

    def dm_right(w):
        return _dm_iord8plus(sh(w(q), 1), sh)

    # (storage column, xt_bl, xt_br) in xppm.py bl_br_edges' order, each
    # form a function of the column's local index
    edges = [
        (h - 1,
         lambda c: at(c, lambda w: S14 * dm_left(w)
                      + S11 * (sh(w(q), -1) - w(q)) + w(q)),
         lambda c: at(c, lambda w: _xt_dxa_edge_0(w(q), w(dxa), sh))),
        (h,
         lambda c: at(c, lambda w: _xt_dxa_edge_1(w(q), w(dxa), sh)),
         lambda c: at(c, lambda w: S15 * w(q) + S11 * sh(w(q), 1)
                      - S14 * dm_right(w))),
        (h + 1,
         lambda c: at(c, lambda w: S15 * sh(w(q), -1) + S11 * w(q)
                      - S14 * w(dm)),
         lambda c: col(al, c + 1)),
        (h + n - 2, lambda c: col(al, c),
         lambda c: at(c, lambda w: S15 * sh(w(q), 1) + S11 * w(q)
                      + S14 * w(dm))),
        (h + n - 1,
         lambda c: at(c, lambda w: S15 * w(q) + S11 * sh(w(q), -1)
                      + S14 * dm_left(w)),
         lambda c: at(c, lambda w: _xt_dxa_edge_0(w(q), w(dxa), sh))),
        (h + n,
         lambda c: at(c, lambda w: _xt_dxa_edge_1(w(q), w(dxa), sh)),
         lambda c: at(c, lambda w: S11 * (sh(w(q), 1) - w(q))
                      - S14 * dm_right(w) + w(q))),
    ]
    held = [(dom.line(axis, g), xt_bl, xt_br) for g, xt_bl, xt_br in edges]
    held = [(c, xt_bl(c), xt_br(c)) for c, xt_bl, xt_br in held
            if c is not None]
    bl, br = bl.clone(), br.clone()
    for c, xt_bl, xt_br in held:
        col(bl, c).copy_(xt_bl - col(q, c))
        col(br, c).copy_(xt_br - col(q, c))
    if constraint_cols is None:
        constraint_cols = [g for g, _, _ in edges]
    constraint_cols = [c for c in (dom.line(axis, g) for g in constraint_cols)
                       if c is not None]
    limited = [(c, *pert_ppm_standard_constraint(col(q, c), col(bl, c),
                                                 col(br, c)))
               for c in constraint_cols]
    for c, bl_c, br_c in limited:
        col(bl, c).copy_(bl_c)
        col(br, c).copy_(br_c)
    return bl, br


def _flux_core(q, courant, dgrid, dom, ord_, sh, upd, axis):
    mord = abs(ord_)
    if mord < 8:
        al = _compute_al(q, dgrid, dom, sh, upd)
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
    bl, br = _compute_blbr_ord8plus(q, dgrid, dom, sh, upd, axis)
    b0 = bl + br
    fx1 = _fx1_fn(courant, br, b0, bl, sh)
    return torch.where(courant > 0.0, sh(q, -1) + fx1, q + fx1)


def x_flux(q, courant, dxa, dom, iord):
    """PPM flux of q across x-interfaces given interface courant numbers."""
    sh, upd = _ax_ops(1, dom)
    return _flux_core(q, courant, dxa, dom, iord, sh, upd, 1)


def y_flux(q, courant, dya, dom, jord):
    """PPM flux across y-interfaces: the x operator with the axis switched."""
    sh, upd = _ax_ops(2, dom)
    return _flux_core(q, courant, dya, dom, jord, sh, upd, 2)
