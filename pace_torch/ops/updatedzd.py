"""Height advection on the D grid (updatedzd).

Port of `pace_tpu.ops.updatedzd` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/updatedzd.py `UpdateHeightOnDGrid`): cubic-spline interpolation of courant numbers / area
fluxes from layer centers to interfaces, FiniteVolumeTransport of interface
heights, del-n diffusive height fluxes, and application with the implied
surface vertical wind.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pace_torch.ops import delnflux as delnflux_mod
from pace_torch.ops.fvtp2d import fv_tp_2d
from pace_torch.ops.stencil_utils import shift
from pace_torch.ops.updatedz import enforce_monotone


def cubic_spline_interpolation_constants(dp0: np.ndarray):
    """gk/beta/gamma columns for center->interface interpolation
    (updatedzd.py:137)."""
    nz = dp0.shape[0]
    gk = np.zeros(nz)
    beta = np.zeros(nz)
    gamma = np.zeros(nz)
    gk[0] = dp0[1] / dp0[0]
    beta[0] = gk[0] * (gk[0] + 0.5)
    gamma[0] = (1.0 + gk[0] * (gk[0] + 1.5)) / beta[0]
    gk[1:] = dp0[:-1] / dp0[1:]
    for i in range(1, nz):
        beta[i] = 2.0 + 2.0 * gk[i] - gamma[i - 1]
        gamma[i] = gk[i] / beta[i]
    return gk, beta, gamma


def interpolation_matrix(dp0: np.ndarray) -> np.ndarray:
    """Dense (nz, nz+1) matrix M with qe = q @ M equal to the cubic-spline
    center->interface interpolation.

    The spline solve is linear in q with coefficients that depend only on
    the static reference column dp0, so the forward/backward-substitution
    recurrence collapses into one matrix built once (numpy float64, one
    row per basis vector) and applied as one matrix product per call."""
    nz = dp0.shape[0]
    gk, beta, gamma = cubic_spline_interpolation_constants(dp0)
    m = np.zeros((nz, nz + 1))
    for j in range(nz):
        q = np.zeros(nz)
        q[j] = 1.0
        m[j] = _interpolate_scan_reference(q, gk, beta, gamma)
    return m


def _interpolate_scan_reference(q: np.ndarray, gk, beta, gamma):
    """Sequential-substitution reference (numpy, one column)."""
    nz = q.shape[0]
    qe = np.zeros(nz + 1)
    qe[0] = 2.0 * gk[0] * (gk[0] + 1.0) * q[0] + q[1]
    qe[0] /= beta[0]
    for k in range(1, nz):
        qe[k] = (3.0 * (q[k - 1] + gk[k] * q[k]) - qe[k - 1]) / beta[k]
    a_bot = 1.0 + gk[-1] * (gk[-1] + 1.5)
    xt1 = 2.0 * gk[-1] * (gk[-1] + 1.0)
    xt2 = gk[-1] * (gk[-1] + 0.5) - a_bot * gamma[-1]
    qe[nz] = (xt1 * q[nz - 1] + q[nz - 2] - a_bot * qe[nz - 1]) / xt2
    for k in range(nz - 1, -1, -1):
        qe[k] -= gamma[k] * qe[k + 1]
    return qe


@functools.lru_cache(maxsize=8)
def _interpolation_matrix_cached(dp0_bytes: bytes, nz: int) -> np.ndarray:
    return interpolation_matrix(np.frombuffer(dp0_bytes).reshape(nz))


def interpolate_to_layer_interfaces_matrix(q, m):
    """q: (..., nz); m: (nz, nz+1) numpy. One matrix product -> (...,
    nz+1).  (A float32 product on the card runs in full float32: TF32
    matmul is off by default in PyTorch.)"""
    return torch.matmul(q, torch.as_tensor(m, dtype=q.dtype, device=q.device))


def update_dz_d(
    surface_height, height, crx, cry, x_area_flux, y_area_flux,
    gd, col, config, dom, dt, dp0,
):
    """Returns (height, ws). dp0: (nz,) static numpy reference
    pressure-thickness column."""
    dp0_64 = np.asarray(dp0, dtype=np.float64)
    m = _interpolation_matrix_cached(dp0_64.tobytes(), dp0_64.shape[0])
    stacked = torch.stack([crx, x_area_flux, cry, y_area_flux])
    crx_i, xaf_i, cry_i, yaf_i = interpolate_to_layer_interfaces_matrix(
        stacked, m
    )

    fx, fy = fv_tp_2d(
        height, crx_i, cry_i, xaf_i, yaf_i, gd, dom, config.hord_tm
    )

    # del-n diffusive height fluxes; the reference passes the raw damp_vt
    # column as the damping factor here (updatedzd.py:343)
    nordc = np.append(np.asarray(col["nord_v"]), col["nord_v"][-1])
    dampc = np.append(np.asarray(col["damp_vt"]), col["damp_vt"][-1])
    fx2, fy2, _ = delnflux_mod.deln_flux_nosg(
        height, gd.damping.del6_u, gd.damping.del6_v, gd.horizontal.rarea,
        nordc, dampc, dom,
    )

    area = gd.horizontal.area[..., None]
    area_after = (
        (area + xaf_i - shift(xaf_i, 1))
        + (area + yaf_i - shift(yaf_i, 0, 1)) - area
    )
    height = (
        height * area + fx - shift(fx, 1) + fy - shift(fy, 0, 1)
    ) / area_after + (fx2 - shift(fx2, 1) + fy2 - shift(fy2, 0, 1)) / area

    ws = (surface_height - height[..., -1]) / dt
    # monotonicity bottom-up: h'_k = max(h_k, h'_{k+1} + DZ_MIN)
    return enforce_monotone(height), ws
