"""Sub-cycled 2D tracer advection (tracer_2d_1l).

Port of `pace_tpu.ops.tracer_advection` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/tracer_2d_1l.py `TracerAdvection`).  By
default the Courant bound is the reference's fixed cmax = 2.0, i.e. exactly
3 substeps.  `dynamic_subcycle=True` takes the Fortran model's
data-dependent split instead: floor(1 + max |Courant|) substeps, the
maximum taken over the compute domain (of every rank: `topo.reduce_max`)
and read to the host once per call (a synchronisation, so it stays off the
default path).  The tracers stay stacked (T, tiles, Ni, Nj, nz) through all
substeps, so each substep is one batched transport call.
"""

from __future__ import annotations

import math

import torch

from pace_torch.ops.fvtp2d import transport_batched
from pace_torch.ops.stencil_utils import shift
from pace_torch.parallel import halo as halo_mod


def _shift_stack(q, di: int = 0, dj: int = 0):
    """shift() for tracer stacks (T, tiles, Ni, Nj, nz): i, j are axes 2,
    3."""
    return shift(q.movedim(0, -1), di, dj).movedim(-1, 0)


def subcycle_count(x_courant, y_courant, dom, topo=None) -> int:
    """The dynamic subcycle's trip count, max(floor(1 + max |C|), 1), the
    maximum over the compute domain (the halo padding may hold NaN): over
    the part each rank owns, then, with a rank topology, over the ranks.
    One host read."""
    cmax = torch.maximum(
        x_courant[(slice(None),) + dom.compute(iface_x=True)].abs().max(),
        y_courant[(slice(None),) + dom.compute(iface_y=True)].abs().max(),
    )
    if topo is not None:
        cmax = topo.reduce_max(cmax)
    return max(int(torch.floor(1.0 + cmax).item()), 1)


def tracer_advection(
    tracers: dict, dp1, x_mass_flux, y_mass_flux, x_courant, y_courant,
    gd, topo, hord_tr, dynamic_subcycle: bool = False,
):
    """Advect tracers (dict of (tiles, Ni, Nj, nz) tensors) on the block
    of `topo.domain`. Returns updated dict."""
    dom = topo.domain
    hz, ang = gd.horizontal, gd.angle
    dxa = hz.dxa[..., None]
    dya = hz.dya[..., None]
    dx = hz.dx[..., None]
    dy = hz.dy[..., None]
    sin1 = ang.sin_sg[..., 0][..., None]
    sin2 = ang.sin_sg[..., 1][..., None]
    sin3 = ang.sin_sg[..., 2][..., None]
    sin4 = ang.sin_sg[..., 3][..., None]
    rarea = hz.rarea[..., None]

    xfx = torch.where(
        x_courant > 0.0,
        x_courant * shift(dxa, -1) * dy * shift(sin3, -1),
        x_courant * dxa * dy * sin1,
    )
    yfx = torch.where(
        y_courant > 0.0,
        y_courant * shift(dya, 0, -1) * dx * shift(sin4, 0, -1),
        y_courant * dya * dx * sin2,
    )

    if dynamic_subcycle:
        n_split = subcycle_count(x_courant, y_courant, dom, topo)
    else:
        n_split = math.floor(1.0 + 2.0)
    frac = 1.0 / n_split
    x_courant = x_courant * frac
    xfx = xfx * frac
    x_mass_flux = x_mass_flux * frac
    y_courant = y_courant * frac
    yfx = yfx * frac
    y_mass_flux = y_mass_flux * frac

    names = list(tracers.keys())
    stacked = torch.stack([tracers[name] for name in names])

    for it in range(n_split):
        dp2 = dp1 + (
            x_mass_flux - shift(x_mass_flux, 1)
            + y_mass_flux - shift(y_mass_flux, 0, 1)
        ) * rarea
        # halo exchange composed with the transport's corner copies: q_y is
        # the halo-updated field with its y-corner copy, q_x adds the
        # x-corner copy
        qy, qx = halo_mod.halo_update_corners(topo, stacked)
        fx, fy = transport_batched(
            qy, qx, x_courant, y_courant, xfx, yfx, x_mass_flux,
            y_mass_flux, hz.dxa, hz.dya, hz.area, dom, hord_tr,
        )
        stacked = (
            qy * dp1
            + (fx - _shift_stack(fx, 1) + fy - _shift_stack(fy, 0, 1))
            * rarea
        ) / dp2
        if it != n_split - 1:
            dp1 = dp2
    return {name: stacked[i] for i, name in enumerate(names)}
