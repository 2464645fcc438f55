"""Del-n (2nd/4th/6th/8th-order) damping fluxes.

Port of `pace_tpu.ops.delnflux` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/delnflux.py `DelnFlux`, `DelnFluxNoSG`).
The damping order can vary per vertical level (a (nz,) "column namelist");
nonzero levels get max(nord) high-order sweeps, selected by a broadcast
level mask.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops.stencil_utils import column, level_mask, shift


def calc_damp(damp_c_col, da_min: float, nord_col):
    """(damp_c * da_min) ** (nord + 1) per level; inputs (nz,) arrays."""
    return (np.asarray(damp_c_col) * da_min) ** (np.asarray(nord_col) + 1.0)


def deln_flux_nosg(q, del6_u, del6_v, rarea, nord_col, damp_col, dom,
                   mass=None):
    """Compute (but do not apply) del-n damping fluxes fx2, fy2 of q.

    nord_col: (nz,) numpy int column; damp_col: (nz,) damp factors.
    Returns (fx2, fy2, d2).

    float32-range note: damp_col = (damp_c*da_min)**(nord+1) reaches ~1e42
    at coarse resolution while the raw del-n iterate shrinks like
    rarea**nord ~ 1e-36 -- both outside float32.  The per-level root factor
    s = damp_col**(1/(nord+1)) (~1e10, float32-safe) is folded into the
    initialization and each sweep, so every intermediate stays in range
    while the accumulated product is mathematically identical."""
    nord_np = np.asarray(nord_col)
    nmax = int(nord_np.max())
    nz_hi = nord_np[nord_np > 0]
    if not (nz_hi.size == 0 or (nz_hi == nmax).all()):
        raise ValueError("per-level nord must share one nonzero value")
    mask_hi = level_mask(nord_np > 0, q)
    s_np = np.asarray(damp_col, np.float64) ** (1.0 / (nord_np + 1.0))
    s_col = column(s_np, q)
    del6_u4 = del6_u[..., None]
    del6_v4 = del6_v[..., None]
    rarea4 = rarea[..., None]

    d2 = s_col * q if mass is None else q

    def ccx(a):
        # the reference fills corners of nord > 0 levels only
        fixed = corner_ops.copy_corners(a, dom, "x")
        return torch.where(mask_hi, fixed, a) if nmax > 0 else a

    def ccy(a):
        fixed = corner_ops.copy_corners(a, dom, "y")
        return torch.where(mask_hi, fixed, a) if nmax > 0 else a

    d2 = ccx(d2)
    fx2 = del6_v4 * (shift(d2, -1) - d2)
    d2 = ccy(d2)
    fy2 = del6_u4 * (shift(d2, 0, -1) - d2)

    for _ in range(nmax):
        d2_new = (fx2 - shift(fx2, 1) + fy2 - shift(fy2, 0, 1)) * rarea4
        d2 = torch.where(mask_hi, d2_new * s_col, d2)
        d2 = ccx(d2)
        fx2 = torch.where(mask_hi, -del6_v4 * (shift(d2, -1) - d2), fx2)
        d2 = ccy(d2)
        fy2 = torch.where(mask_hi, -del6_u4 * (shift(d2, 0, -1) - d2), fy2)

    return fx2, fy2, d2


def deln_flux(q, fx, fy, gd, nord_col, damp_c_col, dom, mass=None):
    """Compute del-n damping fluxes of q and add them to fx/fy (reference
    DelnFlux.__call__). nord_col/damp_c_col are (nz,) numpy columns.
    Returns (fx, fy)."""
    damp_c_np = np.asarray(damp_c_col)
    if (damp_c_np <= 1e-4).all():
        return fx, fy
    damp_col = calc_damp(damp_c_np, gd.damping.da_min, nord_col)
    fx2, fy2, _ = deln_flux_nosg(
        q, gd.damping.del6_u, gd.damping.del6_v, gd.horizontal.rarea,
        nord_col, damp_col, dom, mass=mass,
    )
    if mass is None:
        return fx + fx2, fy + fy2
    # the sweeps applied s**nord inside deln_flux_nosg; one more root factor
    # completes damp = s**(nord+1)
    nord_np = np.asarray(nord_col)
    s_col = column(np.asarray(damp_col, np.float64)
                   ** (1.0 / (nord_np + 1.0)), q)
    fx = fx + 0.5 * s_col * (shift(mass, -1) + mass) * fx2
    fy = fy + 0.5 * s_col * (shift(mass, 0, -1) + mass) * fy2
    return fx, fy
