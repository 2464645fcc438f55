"""Halo updates on global (6, N, N, ...) cubed-sphere tensors.

Port of the gather form of `pace_tpu.parallel.halo` (reference ai2cm/pace
util/pace/util/halo_updater.py:29): a halo update is one advanced-indexing
gather with the precomputed index tables of `CubedSphereTopology`, moved
to the tensor's device once.  Vector updates fuse the tile-edge rotation
(component swap + sign flip) into the gather.

All functions accept tensors with any number of trailing dimensions after
(tile, i, j).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pace_torch.parallel.topology import CubedSphereTopology, HaloSpec


def _expand(idx, ndim_extra):
    """Reshape a (6, N, N) table so it broadcasts over trailing dims."""
    return idx.reshape(idx.shape + (1,) * ndim_extra)


def halo_update_scalar(q: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    """Fill edge halos of a scalar field. Corner wedges keep prior values."""
    t = spec.on(q.device)
    return q[t["t"], t["i"], t["j"]]


def halo_update_scalars(topo: CubedSphereTopology,
                        fields: Sequence[torch.Tensor],
                        stagger: str = "center") -> list:
    """Grouped scalar halo update (one gather per field)."""
    spec = topo.scalar_spec(stagger)
    return [halo_update_scalar(f, spec) for f in fields]


def _vector_gather(u, v, spec: HaloSpec, apply_sign: bool = True):
    t = spec.on(u.device)
    ndim_extra = u.ndim - 3
    from_u = u[t["t"], t["i"], t["j"]]
    from_v = v[t["t"], t["i"], t["j"]]
    out = torch.where(_expand(t["comp"], ndim_extra) == 0, from_u, from_v)
    if apply_sign:
        out = _expand(t["sign"], ndim_extra).to(u.dtype) * out
    return out


def halo_update_vector(topo: CubedSphereTopology, u, v, u_stagger: str,
                       v_stagger: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill edge halos of a vector pair, rotating components across tile
    edges.  For D-grid winds use (u_stagger="y_iface", v_stagger="x_iface");
    C-grid ("x_iface", "y_iface"); A-grid ("center", "center")."""
    u_spec, v_spec = topo.vector_spec(u_stagger, v_stagger)
    return _vector_gather(u, v, u_spec), _vector_gather(u, v, v_spec)


def synchronize_vector_interfaces(topo: CubedSphereTopology, u, v,
                                  u_stagger: str, v_stagger: str):
    """Make edge-shared interface points of a vector pair agree across tiles
    (reference communicator.py:472-519): points on a tile's west/south
    compute-domain boundary take the neighbouring tile's value."""
    u_map, v_map = topo.interface_sync_map(u_stagger, v_stagger)
    return _vector_gather(u, v, u_map), _vector_gather(u, v, v_map)
