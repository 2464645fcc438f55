"""Physics state container.

Port of `pace_tpu.models.physics.physics_state` (reference ai2cm/pace
physics/pace/physics/physics_state.py `PhysicsState`): a dataclass of
tensors (shape (..., nz) for 3D fields, (...,) for 2D) on one device.
`physics_updated_*` fields hold the forward-Euler-updated values the
coupler consumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PhysicsState:
    qvapor: torch.Tensor
    qliquid: torch.Tensor
    qrain: torch.Tensor
    qice: torch.Tensor
    qsnow: torch.Tensor
    qgraupel: torch.Tensor
    qo3mr: torch.Tensor
    qsgs_tke: torch.Tensor
    qcld: torch.Tensor
    pt: torch.Tensor
    delp: torch.Tensor
    delz: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    w: torch.Tensor
    omga: torch.Tensor
    # physics-updated prognostics (reference physics_state.py:137-260)
    physics_updated_specific_humidity: torch.Tensor
    physics_updated_qliquid: torch.Tensor
    physics_updated_qrain: torch.Tensor
    physics_updated_qice: torch.Tensor
    physics_updated_qsnow: torch.Tensor
    physics_updated_qgraupel: torch.Tensor
    physics_updated_cloud_fraction: torch.Tensor
    physics_updated_pt: torch.Tensor
    physics_updated_ua: torch.Tensor
    physics_updated_va: torch.Tensor
    # diagnostic/auxiliary (reference physics_state.py:260-330)
    delprsi: torch.Tensor  # GFS-mass layer thickness
    phii: torch.Tensor  # interface geopotential, (..., nz+1)
    phil: torch.Tensor  # layer geopotential
    dz: torch.Tensor
    wmp: torch.Tensor
    prsi: torch.Tensor  # interface pressure, (..., nz+1)
    prsik: torch.Tensor  # log/exner hybrid per reference statein
    land: torch.Tensor  # 2D land fraction

    @classmethod
    def init_zeros(cls, shape3, device="cuda", dtype=torch.float32):
        """shape3 = (..., nz)."""
        shape3 = tuple(shape3)
        nz = shape3[-1]
        shape2 = shape3[:-1]
        z3 = torch.zeros(shape3, device=device, dtype=dtype)
        zi = torch.zeros(shape2 + (nz + 1,), device=device, dtype=dtype)
        z2 = torch.zeros(shape2, device=device, dtype=dtype)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in ("phii", "prsi"):
                kwargs[f.name] = zi
            elif f.name == "land":
                kwargs[f.name] = z2
            else:
                kwargs[f.name] = z3
        return cls(**kwargs)

    @classmethod
    def from_numpy(cls, arrays: dict, device, dtype) -> "PhysicsState":
        """Build from numpy arrays keyed by the field names of `pace_tpu`'s
        PhysicsState."""
        return cls(**{
            f.name: torch.tensor(np.asarray(arrays[f.name]), dtype=dtype,
                                 device=device)
            for f in dataclasses.fields(cls)
        })
