"""PPM advection of D-grid winds along their own direction (xtp_u / ytp_v).

Port of `pace_tpu.ops.xtp` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/xtp_u.py `advect_u_along_x` and ytp_v.py
`advect_v_along_y`), used inline by d_sw's kinetic-energy computation.
"""

from __future__ import annotations

import torch

from pace_torch.ops import xppm


def _corner_zero_mask(like, dom, ii, jj):
    """Mask of the cube-corner wind points (d_sw zeroes bl/br there) at
    the storage points ii x jj the block holds."""
    m = torch.zeros((like.shape[1], like.shape[2]), dtype=torch.bool,
                    device=like.device)
    for i in filter(lambda i: i is not None, map(dom.col, ii)):
        for j in filter(lambda j: j is not None, map(dom.row, jj)):
            m[i, j] = True
    return m.reshape((1,) + m.shape + (1,) * (like.ndim - 3))


def _advect_along(w, wb_contra, rd, d, da, dt, dom, ord_, axis):
    n, h = dom.n, dom.h
    sh, upd = xppm._ax_ops(axis, dom)
    if abs(ord_) < 8:
        al = xppm._compute_al(w, d, dom, sh, upd)
        bl = al - w
        br = sh(al, 1) - w
    else:
        # xtp_u applies the PPM constraint only on the i_start+1 and
        # i_end-1 columns (xtp_u.py get_bl_br), unlike xppm
        bl, br = xppm._compute_blbr_ord8plus(
            w, da, dom, sh, upd, axis, constraint_cols=(h + 1, h + n - 2)
        )
    # zero corners: along-axis i in {h-1, h, h+n-1, h+n}, cross j in {h, h+n}
    ii = (h - 1, h, h + n - 1, h + n)
    jj = (h, h + n)
    mask0 = (_corner_zero_mask(w, dom, ii, jj) if axis == 1
             else _corner_zero_mask(w, dom, jj, ii))
    bl = torch.where(mask0, 0.0, bl)
    br = torch.where(mask0, 0.0, br)
    b0 = bl + br
    cfl = torch.where(
        wb_contra > 0.0, wb_contra * dt * sh(rd, -1), wb_contra * dt * rd
    )
    fx0 = xppm._fx1_fn(cfl, br, b0, bl, sh)
    if abs(ord_) < 8:
        if abs(ord_) == 5:
            smt5 = bl * br < 0.0
        else:
            smt5 = (3.0 * torch.abs(b0)) < torch.abs(bl - br)
        mask = torch.where(torch.logical_or(sh(smt5, -1), smt5), 1.0, 0.0)
        mask = mask.to(w.dtype)
    else:
        mask = 1.0
    return torch.where(
        wb_contra > 0.0, sh(w, -1) + fx0 * mask, w + fx0 * mask
    )


def advect_u_along_x(u, ub_contra, rdx, dx, dxa, dt, dom, iord):
    """u advected to cell corners by the contravariant corner wind."""
    return _advect_along(u, ub_contra, rdx, dx, dxa, dt, dom, iord, axis=1)


def advect_v_along_y(v, vb_contra, rdy, dy, dya, dt, dom, jord):
    return _advect_along(v, vb_contra, rdy, dy, dya, dt, dom, jord, axis=2)
