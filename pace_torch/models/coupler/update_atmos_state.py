"""Dycore <-> physics coupling.

Port of `pace_tpu.models.coupler.update_atmos_state` (reference ai2cm/pace
stencils/pace/stencils/update_atmos_state.py): `DycoreToPhysics`
(copy_dycore_to_physics) and `UpdateAtmosphereState` (fill_gfs_delp,
prepare_tendencies_and_update_tracers + ApplyPhysicsToDycore).

Whole-tile global-view note: physics columns are independent, so the
physics runs over the full padded (6, N, N, nz) arrays.  Padded columns
(outside the active n x n region) carry zeros from initialization, which
would produce 0/0; DycoreToPhysics substitutes a benign reference column
there, and UpdateAtmosphereState masks all writes back to the interior.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pace_torch.models.coupler.fv_update_phys import apply_physics_to_dycore
from pace_torch.models.physics.physics_state import PhysicsState
from pace_torch.ops.stencil_utils import levels
from pace_torch.utils.gridtools import Domain


def interior_mask(dom, device="cuda"):
    """(1, Ni, Nj, 1) mask of the active cell-center columns of `dom`'s
    block (utils/gridtools.py Domain)."""
    ci = np.arange(dom.Ni) + dom.i0
    cj = np.arange(dom.Nj) + dom.j0
    ci = (ci >= dom.h) & (ci < dom.h + dom.n)
    cj = (cj >= dom.h) & (cj < dom.h + dom.n)
    return torch.as_tensor(ci[:, None] & cj[None, :], device=device).reshape(
        1, dom.Ni, dom.Nj, 1)


def fill_gfs_delp(delp, q, q_min: float):
    """Vertical borrowing to enforce q >= q_min (reference
    update_atmos_state.py:20-37 fill_gfs_delp; only q is modified)."""
    q_l, dp_l = list(levels(q)), levels(delp)
    nz = len(q_l)

    # upward sweep: if q[k+1] < q_min, borrow from q[k] (descending k,
    # using the already-updated q[k+1])
    for k in range(nz - 2, -1, -1):
        q_l[k] = q_l[k] + torch.where(
            q_l[k + 1] < q_min,
            (q_l[k + 1] - q_min) * dp_l[k + 1] / dp_l[k], 0.0,
        )

    # downward sweep: all but the top level clamped to q_min, then any
    # remaining negative mass propagated downward
    for k in range(1, nz):
        q_l[k] = torch.clamp(q_l[k], min=q_min) + torch.where(
            q_l[k - 1] < 0.0, q_l[k - 1] * dp_l[k - 1] / dp_l[k], 0.0
        )
    return torch.clamp(torch.stack(q_l, -1), min=0.0)


def prepare_tendencies_and_update_tracers(
    u_dt, v_dt, pt_dt, phy: PhysicsState, dyc: dict, rdt: float,
):
    """Gather wind/temperature tendencies and convert the GFS-updated
    tracers back to FV3 (total-mass) mixing ratios, adjusting delp
    (reference update_atmos_state.py:40-94).  Returns
    (u_dt, v_dt, pt_dt, new_tracers dict, new_delp)."""
    u_dt = u_dt + (phy.physics_updated_ua - phy.ua) * rdt
    v_dt = v_dt + (phy.physics_updated_va - phy.va) * rdt
    pt_dt = pt_dt + (phy.physics_updated_pt - phy.pt) * rdt
    dp = phy.prsi[..., 1:] - phy.prsi[..., :-1]
    qwat = {
        "qvapor": dp * phy.physics_updated_specific_humidity,
        "qliquid": dp * phy.physics_updated_qliquid,
        "qrain": dp * phy.physics_updated_qrain,
        "qsnow": dp * phy.physics_updated_qsnow,
        "qice": dp * phy.physics_updated_qice,
        "qgraupel": dp * phy.physics_updated_qgraupel,
    }
    qt = sum(qwat.values())
    q_sum = (
        dyc["qvapor"] + dyc["qliquid"] + dyc["qrain"] + dyc["qsnow"]
        + dyc["qice"] + dyc["qgraupel"]
    )
    q0 = dyc["delp"] * (1.0 - q_sum) + qt
    new_tracers = {name: w / q0 for name, w in qwat.items()}
    return u_dt, v_dt, pt_dt, new_tracers, q0


class DycoreToPhysics:
    """Copies dycore prognostics into a PhysicsState (reference
    DycoreToPhysics, update_atmos_state.py:151-233).  When
    do_dry_convective_adjust is set, runs fv_subgridz first via
    `dry_convective_adjust` (call it before this; the reference gates it
    on fv_sg_adj > 0)."""

    def __init__(self, sizing, dtype=torch.float32, dycore_only=False,
                 device="cuda", domain=None):
        """`domain`: the block of each tile the states hold (a rank's, under
        a layout that splits tiles); the whole tile by default."""
        self.sizing = sizing
        self.dycore_only = dycore_only
        self.device = torch.device(device)
        domain = domain or Domain.whole(sizing.n, sizing.halo)
        self._mask = interior_mask(domain, device=self.device)
        self.dtype = dtype

    def __call__(self, dycore_state, land=None) -> PhysicsState:
        s = dycore_state
        m = self._mask

        def safe(x, fill):
            return torch.where(m, x, fill)

        shape3 = s.pt.shape
        phys = PhysicsState.init_zeros(shape3, device=s.pt.device,
                                       dtype=s.pt.dtype)
        return dataclasses.replace(
            phys,
            qvapor=safe(s.qvapor, 0.0), qliquid=safe(s.qliquid, 0.0),
            qrain=safe(s.qrain, 0.0), qice=safe(s.qice, 0.0),
            qsnow=safe(s.qsnow, 0.0), qgraupel=safe(s.qgraupel, 0.0),
            qo3mr=safe(s.qo3mr, 0.0), qsgs_tke=safe(s.qsgs_tke, 0.0),
            qcld=safe(s.qcld, 0.0), pt=safe(s.pt, 273.0),
            delp=safe(s.delp, 1.0e3), delz=safe(s.delz, -100.0),
            ua=safe(s.ua, 0.0), va=safe(s.va, 0.0), w=safe(s.w, 0.0),
            omga=safe(s.omga, 0.0),
            land=(land if land is not None
                  else torch.zeros_like(s.pt[..., 0])),
        )


class UpdateAtmosphereState:
    """Applies physics tendencies and rebuilds a consistent prognostic
    state (reference UpdateAtmosphereState, update_atmos_state.py:235-349;
    Fortran atmosphere_state_update)."""

    def __init__(self, grid_data, topo, sizing, timestep: float,
                 c2l_order: int = 4, dycore_only: bool = False,
                 apply_tendencies: bool = True, device="cuda"):
        self.gd = grid_data
        self.topo = topo
        self.sizing = sizing
        self.timestep = timestep
        self.c2l_order = c2l_order
        self.dycore_only = dycore_only
        self.apply_tendencies = apply_tendencies
        self._rdt = 1.0 / timestep
        self.device = torch.device(device)
        if grid_data.device.type != self.device.type:
            raise ValueError(
                f"grid data on {grid_data.device}, coupler on {self.device}")
        self._mask = interior_mask(topo.domain, device=self.device)

    def __call__(self, dycore_state, phy_state: PhysicsState,
                 u_dt0=None, v_dt0=None, pt_dt0=None):
        """Returns the updated DycoreState.  u_dt0/v_dt0/pt_dt0 seed the
        tendency accumulators (e.g. from fv_subgridz)."""
        s = {
            f.name: getattr(dycore_state, f.name)
            for f in dataclasses.fields(dycore_state)
        }
        m = self._mask
        if self.dycore_only:
            s["qvapor"] = torch.where(
                m, fill_gfs_delp(s["delp"], s["qvapor"], 1.0e-9),
                s["qvapor"],
            )
            return dataclasses.replace(dycore_state, qvapor=s["qvapor"])

        qv_up = fill_gfs_delp(
            s["delp"], phy_state.physics_updated_specific_humidity, 1.0e-9
        )
        phy_state = dataclasses.replace(
            phy_state, physics_updated_specific_humidity=qv_up
        )
        u_dt = u_dt0 if u_dt0 is not None else torch.zeros_like(s["pt"])
        v_dt = v_dt0 if v_dt0 is not None else torch.zeros_like(s["pt"])
        pt_dt = pt_dt0 if pt_dt0 is not None else torch.zeros_like(s["pt"])
        u_dt, v_dt, pt_dt, new_tracers, new_delp = (
            prepare_tendencies_and_update_tracers(
                u_dt, v_dt, pt_dt, phy_state, s, self._rdt
            )
        )
        # all writes masked to the interior (padded physics columns are
        # synthetic; see module docstring)
        for name, val in new_tracers.items():
            s[name] = torch.where(m, val, s[name])
        s["delp"] = torch.where(m, new_delp, s["delp"])
        u_dt = torch.where(m, u_dt, 0.0)
        v_dt = torch.where(m, v_dt, 0.0)
        pt_dt = torch.where(m, pt_dt, 0.0)

        if self.apply_tendencies:
            s, u_srf, v_srf = apply_physics_to_dycore(
                s, u_dt, v_dt, pt_dt, self.gd, self.topo,
                self.c2l_order, self.timestep,
            )
        return type(dycore_state)(**s)
