"""Geopotential-height updates on the C and D grids.

Port of `pace_tpu.ops.updatedz` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/updatedzc.py
`UpdateGeopotentialHeightOnCGrid`).
"""

from __future__ import annotations

import torch

from pace_torch.ops import corners as corner_ops
from pace_torch.ops.stencil_utils import shift
from pace_torch.utils.constants import DZ_MIN


def _interface_interp(vel, dp0):
    """Interpolate a layer field to interfaces with pressure-thickness
    weights (updatedzc.py p_weighted_average_*). vel (..., nz), dp0 (nz,);
    returns (..., nz+1)."""
    top = vel[..., :1] + (vel[..., :1] - vel[..., 1:2]) * (
        dp0[0] / (dp0[0] + dp0[1])
    )
    interior = (dp0[1:] * vel[..., :-1] + dp0[:-1] * vel[..., 1:]) / (
        dp0[:-1] + dp0[1:]
    )
    bottom = vel[..., -1:] + (vel[..., -1:] - vel[..., -2:-1]) * (
        dp0[-1] / (dp0[-2] + dp0[-1])
    )
    return torch.cat([top, interior, bottom], -1)


def enforce_monotone(gz):
    """gz_k = max(gz_k, gz_{k+1} + DZ_MIN) applied bottom-up (..., nz+1),
    as the reverse cumulative max of gz + k*DZ_MIN shifted back by
    k*DZ_MIN (the reference package's form)."""
    korr = DZ_MIN * torch.arange(gz.shape[-1], dtype=gz.dtype,
                                 device=gz.device)
    b = gz + korr
    rev = torch.flip(torch.cummax(torch.flip(b, (-1,)), -1).values, (-1,))
    return rev - korr


def update_dz_c(dp_ref, zs, area, ut, vt, gz, dom, dt):
    """Advance interface heights on the C grid.

    Args:
        dp_ref: (nz,) reference layer pressure thickness
        zs: (6, N, N) surface height [m]
        area: (6, N, N)
        ut, vt: (6, N, N, nz) C-grid volume fluxes from c_sw
        gz: (6, N, N, nz+1) interface geopotential height [m]
    Returns (gz, ws): updated heights and implied surface vertical wind.
    """
    gz_x = corner_ops.fill_corners_cells(gz, gz, dom, "x", 2)
    gz_y = corner_ops.fill_corners_cells(gz, gz, dom, "y", 2)

    xfx = _interface_interp(ut, dp_ref)
    yfx = _interface_interp(vt, dp_ref)

    fx = xfx * torch.where(xfx > 0.0, shift(gz_x, -1), gz_x)
    fy = yfx * torch.where(yfx > 0.0, shift(gz_y, 0, -1), gz_y)
    area4 = area[..., None]
    gz_new = (gz * area4 + fx - shift(fx, 1) + fy - shift(fy, 0, 1)) / (
        area4 + xfx - shift(xfx, 1) + yfx - shift(yfx, 0, 1)
    )
    ws = (zs - gz_new[..., -1]) / dt
    gz_new = enforce_monotone(gz_new)
    return gz_new, ws
