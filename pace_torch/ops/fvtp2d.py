"""2D finite-volume flux-form transport (fv_tp_2d) and its CUDA kernel.

Port of `pace_tpu.ops.fvtp2d` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/fvtp2d.py `FiniteVolumeTransport`):
directionally-split PPM transport (Putman & Lin 2007 eq. 16-18) with
optional fused del-n damping.

`transport_batched` computes the undamped fluxes of T stacked fields that
share Courant numbers, area fluxes, unit fluxes and metrics.  On a CPU
tensor it runs `transport_batched_plain` (the whole-array torch version);
on a CUDA tensor it launches the hand-written kernel of csrc/fvtp2d.cu,
which replaces `pace_tpu.ops.pallas.fvtp2d_pallas.transport_batched`.
"""

from __future__ import annotations

import torch

from pace_torch.ops import bounds
from pace_torch.ops import corners as corner_ops
from pace_torch.ops.delnflux import deln_flux
from pace_torch.ops.stencil_utils import shift
from pace_torch.ops.xppm import x_flux, y_flux

# Launches of the CUDA transport kernel (one per transport_batched call on
# a CUDA tensor); read and reset by chip_smoke.py.
LAUNCHES = 0


def _fluxes_one(q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area,
                dom, hord):
    """fv_tp_2d's undamped fluxes of one field (whole-array torch)."""
    ord_outer = hord
    ord_inner = 8 if hord == 10 else hord
    q_y_advected_mean = y_flux(q_y, cry, dya, dom, ord_inner)
    fyy = yfx * q_y_advected_mean
    q_advected_y = (q_y * area + fyy - shift(fyy, 0, 1)) / (
        area + yfx - shift(yfx, 0, 1)
    )
    q_advected_y_x_advected_mean = x_flux(
        q_advected_y, crx, dxa, dom, ord_outer
    )
    q_x_advected_mean = x_flux(q_x, crx, dxa, dom, ord_inner)
    fx1 = xfx * q_x_advected_mean
    q_advected_x = (q_x * area + fx1 - shift(fx1, 1)) / (
        area + xfx - shift(xfx, 1)
    )
    q_advected_x_y_advected_mean = y_flux(
        q_advected_x, cry, dya, dom, ord_outer
    )
    fx = 0.5 * (q_advected_y_x_advected_mean + q_x_advected_mean) * xmf
    fy = 0.5 * (q_advected_x_y_advected_mean + q_y_advected_mean) * ymf
    return fx, fy


def transport_batched_plain(q_y, q_x, crx, cry, xfx, yfx, xmf, ymf,
                            dxa, dya, area, dom, hord: int):
    """Plain torch version of the batched transport.

    q_y/q_x: (T, tiles, Ni, Nj, nz) corner-copied stacks (copy_corners(q,
    "y") and copy_corners(copy_corners(q, "y"), "x")), any tile count, on
    the block of `dom`; crx/cry/xfx/yfx/xmf/ymf: (tiles, Ni, Nj, nz);
    dxa/dya/area: (tiles, Ni, Nj).  Returns (fx, fy), each (T, tiles, Ni,
    Nj, nz)."""
    dxa, dya, area = dxa[..., None], dya[..., None], area[..., None]
    out = [
        _fluxes_one(q_y[t], q_x[t], crx, cry, xfx, yfx, xmf, ymf, dxa, dya,
                    area, dom, hord)
        for t in range(q_y.shape[0])
    ]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def transport_batched_cuda(q_y, q_x, crx, cry, xfx, yfx, xmf, ymf,
                           dxa, dya, area, dom, hord: int):
    """The batched transport as one launch of the CUDA kernel (same
    arguments and results as transport_batched_plain, every hord): any
    tile count and block extents (Ni, Nj), the tile's edge lines at their
    local indices along each axis (outside [0, Ni) or [0, Nj) where the
    block does not hold them)."""
    global LAUNCHES
    from pace_torch.ops import _cuda

    T, tiles, Ni, Nj, nz = q_y.shape
    shared = (crx, cry, xfx, yfx, xmf, ymf)
    _cuda.check(q_y, q_x, shape=(T, tiles, dom.Ni, dom.Nj, nz))
    _cuda.check(*shared, shape=(tiles, Ni, Nj, nz), dtype=q_y.dtype)
    _cuda.check(dxa, dya, area, shape=(tiles, Ni, Nj), dtype=q_y.dtype)
    fx, fy = torch.empty_like(q_y), torch.empty_like(q_y)
    _cuda.launch(
        "fvtp2d", q_y.dtype,
        q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area, fx, fy,
        ints=(T, tiles, Ni, Nj, nz, *dom.edge_lines(1), *dom.edge_lines(2),
              hord),
    )
    LAUNCHES += 1
    return fx, fy


def transport_batched(q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya,
                      area, dom, hord: int):
    """Batched fv_tp_2d fluxes (no damping); see transport_batched_plain.
    A CPU tensor takes the plain version, a CUDA tensor the kernel."""
    args = (q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area)
    with bounds.kernel_call("K-T") as report:
        if q_y.is_cuda:
            out = transport_batched_cuda(*args, dom, hord)
        else:
            out = transport_batched_plain(*args, dom, hord)
        report(args, out, q_y.numel())
    return out


def fv_tp_2d(
    q, crx, cry, x_area_flux, y_area_flux, gd, dom, hord: int,
    nord_col=None, damp_c_col=None, x_mass_flux=None, y_mass_flux=None,
    mass=None, q_y=None, q_x=None,
):
    """Compute transport fluxes (q_x_flux, q_y_flux) of q.

    Args:
        q: transported scalar (tiles, Ni, Nj, nz) of dom's block
        crx/cry: Courant numbers on x/y interfaces
        x_area_flux/y_area_flux: area fluxes [m^2]
        hord: PPM order (ord_inner = 8 if hord == 10 else hord)
        nord_col/damp_c_col: optional (nz,) damping columns (fused DelnFlux)
        x_mass_flux/y_mass_flux: if given, the output flux units are q*mass
        q_y/q_x: optionally precomputed corner copies
    """
    if q_y is None:
        q_y = corner_ops.copy_corners(q, dom, "y")
    if q_x is None:
        q_x = corner_ops.copy_corners(q_y, dom, "x")
    hz = gd.horizontal
    fx, fy = transport_batched(
        q_y[None].contiguous(), q_x[None].contiguous(), crx, cry,
        x_area_flux, y_area_flux,
        x_area_flux if x_mass_flux is None else x_mass_flux,
        y_area_flux if y_mass_flux is None else y_mass_flux,
        hz.dxa, hz.dya, hz.area, dom, hord,
    )
    fx, fy = fx[0], fy[0]
    if nord_col is not None and damp_c_col is not None:
        fx, fy = deln_flux(q_x, fx, fy, gd, nord_col, damp_c_col, dom,
                           mass=mass)
    return fx, fy
