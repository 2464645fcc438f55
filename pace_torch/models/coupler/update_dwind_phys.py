"""A-grid physics wind tendencies -> D-grid wind update.

Port of `pace_tpu.models.coupler.update_dwind_phys` (reference ai2cm/pace
stencils/pace/stencils/update_dwind_phys.py `AGrid2DGridPhysics`, Fortran
update_dwinds_phys): geographic (east/north) A-grid tendencies are lifted
to 3D cartesian vectors via vlon/vlat, averaged to the D-grid wind points,
corrected along tile edges with the edge_vect interpolation factors, and
projected onto the local es1/ew2 basis vectors.

Tile-storage view: the reference's rank-dependent edge-region bookkeeping
(update_dwind_phys.py:157-420) collapses to four static lines of the
tile's storage, written where the rank's block (`Domain`) holds them; the
half-tile split at im2/jm2 picks which neighbour the edge interpolation
leans on.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.ops.stencil_utils import shift
from pace_torch.parallel import halo as halo_mod


def _edge_neighbor_index(dom, axis: int):
    """Cell j uses neighbor j+1 in the lower half-tile, j-1 in the upper
    (reference jm2 = (npy-1)/2 + 2 split, update_dwind_phys.py:233-258):
    local indices along `axis` of dom's block, clipped to it."""
    size = dom.Ni if axis == 1 else dom.Nj
    offset = dom.i0 if axis == 1 else dom.j0
    idx = np.arange(size)
    lower = idx + offset < dom.h + dom.n // 2
    return np.where(lower, np.clip(idx + 1, 0, size - 1),
                    np.clip(idx - 1, 0, size - 1))


def _active(dom, axis: int, iface: bool):
    """Along `axis` of dom's block: the compute cells, or interfaces."""
    size = dom.Ni if axis == 1 else dom.Nj
    g = np.arange(size) + (dom.i0 if axis == 1 else dom.j0)
    return (g >= dom.h) & (g < dom.h + dom.n + int(iface))


def update_dwind_phys(u, v, u_dt, v_dt, gd, topo, dt):
    """Returns (u, v) with dt * tendencies applied on the D-grid, on the
    block of `topo.domain`."""
    dom = topo.domain
    n, h = dom.n, dom.h
    hz = gd.horizontal
    center = topo.scalar_spec("center")
    # geographic components are frame-invariant across tile edges, so a
    # scalar exchange is correct (the reference uses scalar halo updaters
    # for u_dt/v_dt, fv_update_phys.py:137-148)
    u_dt = halo_mod.halo_update_scalar(u_dt, center)
    v_dt = halo_mod.halo_update_scalar(v_dt, center)

    # 3D cartesian tendency at cell centers: (6, N, N, nz, 3)
    vlon = hz.vlon[:, :, :, None, :]
    vlat = hz.vlat[:, :, :, None, :]
    v3 = u_dt[..., None] * vlon + v_dt[..., None] * vlat

    # average to wind points: ue at y-interfaces, ve at x-interfaces
    ue = shift(v3, 0, -1) + v3
    ve = shift(v3, -1) + v3

    nbr_j = torch.as_tensor(_edge_neighbor_index(dom, 2), device=u.device)
    nbr_i = torch.as_tensor(_edge_neighbor_index(dom, 1), device=u.device)
    # west/east tile edges correct ve along the edge columns
    evw = hz.edge_vect_w[:, :, None, None]
    eve = hz.edge_vect_e[:, :, None, None]
    for i_col, ev in ((dom.col(h), evw), (dom.col(h + n), eve)):
        if i_col is None:
            continue
        col = ve[:, i_col]
        vt = ev * col[:, nbr_j] + (1.0 - ev) * col
        ve[:, i_col] = vt
    # south/north tile edges correct ue along the edge rows
    evs = hz.edge_vect_s[:, :, None, None]
    evn = hz.edge_vect_n[:, :, None, None]
    for j_row, ev in ((dom.row(h), evs), (dom.row(h + n), evn)):
        if j_row is None:
            continue
        row = ue[:, :, j_row]
        ut = ev * row[:, nbr_i] + (1.0 - ev) * row
        ue[:, :, j_row] = ut

    dt5 = 0.5 * dt
    du = dt5 * (ue * hz.es1[:, :, :, None, :]).sum(-1)
    dv = dt5 * (ve * hz.ew2[:, :, :, None, :]).sum(-1)

    # apply only on the active wind points
    shape = (1, dom.Ni, dom.Nj, 1)
    mask_u = torch.as_tensor(
        _active(dom, 1, False)[:, None] & _active(dom, 2, True)[None, :],
        device=u.device).reshape(shape)
    mask_v = torch.as_tensor(
        _active(dom, 1, True)[:, None] & _active(dom, 2, False)[None, :],
        device=u.device).reshape(shape)
    u = torch.where(mask_u, u + du, u)
    v = torch.where(mask_v, v + dv, v)
    return u, v
