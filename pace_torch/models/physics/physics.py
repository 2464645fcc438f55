"""Physics driver: GFS state-in conversion, pressure/geopotential
diagnostics, and the microphysics package.

Port of `pace_tpu.models.physics.physics` (reference ai2cm/pace
physics/pace/physics/stencils/physics.py `Physics`,
atmos_phys_driver_statein:33-110, prepare_microphysics:113-146,
update_physics_state_with_tendencies:154-200, plus get_prs_fv3.py and
get_phi_fv3.py).

All fields are (..., nz) with k the last axis (top at k=0); interface
fields are (..., nz+1).  Everything is elementwise or a cumulative sum
along k.
"""

from __future__ import annotations

import dataclasses

import torch

from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.models.physics.emulator import MicrophysicsEmulator
from pace_torch.models.physics.microphysics import (
    Microphysics,
    MicrophysicsState,
)
from pace_torch.models.physics.physics_state import PhysicsState
from pace_torch.ops.stencil_utils import (
    cumsum_k,
    maximum,
    minimum,
    reverse_cumsum,
)
from pace_torch.utils import constants as con

P00 = 1.0e5


def atmos_phys_driver_statein(state: PhysicsState, ptop, pktop, pk0inv,
                              nwat=6):
    """FV3 -> GFS state conversion (reference physics.py:33-110):
    interface geopotential from delz, condensate-stripped air mass,
    GFS mixing ratios (per dry+vapor mass), hydrostatic layer pressure."""
    delp = state.delp
    # interface geopotential: phii[nz] = 0 (surface), building upward
    dphi = -state.delz * con.GRAV  # positive
    phii_above = reverse_cumsum(dphi)
    phii = torch.cat([phii_above, torch.zeros_like(delp[..., :1])], -1)

    # tracer masses (qsgs_tke intentionally not mass-weighted, as in the
    # reference's first loop: physics.py:60-67)
    qv = state.qvapor * delp
    ql = state.qliquid * delp
    qr = state.qrain * delp
    qi = state.qice * delp
    qs = state.qsnow * delp
    qg = state.qgraupel * delp
    qo3 = state.qo3mr * delp
    if nwat == 6:
        delp = delp - ql - qr - qi - qs - qg

    # interface pressures from the stripped masses
    prsi = torch.cat(
        [torch.full_like(delp[..., :1], ptop),
         ptop + cumsum_k(delp)], -1,
    )
    qv, ql, qr, qi, qs, qg, qo3 = (
        x / delp for x in (qv, ql, qr, qi, qs, qg, qo3)
    )
    qtke = state.qsgs_tke / delp

    # hydrostatic layer mean pressure, bounded inside the interfaces
    qgrs_rad = maximum(1.0e-10, qv)
    rtv = con.RDGAS * state.pt * (1.0 + con.ZVIR * qgrs_rad)
    dm = delp
    prsl = dm * rtv / (phii[..., :-1] - phii[..., 1:])
    prsl = minimum(prsl, prsi[..., 1:] - 0.01 * dm)
    prsl = maximum(prsl, prsi[..., :-1] + 0.01 * dm)

    # prsik: log(prsi) in the column, Exner at the bottom interface, pktop
    # at the top (faithful to the reference's partial overwrites,
    # physics.py:90-110)
    prsik = torch.log(prsi)
    prsik = torch.cat(
        [torch.full_like(prsik[..., :1], pktop),
         prsik[..., 1:-1],
         torch.exp(con.KAPPA * prsik[..., -1:]) * pk0inv], -1,
    )
    return dataclasses.replace(
        state, qvapor=qv, qliquid=ql, qrain=qr, qice=qi, qsnow=qs,
        qgraupel=qg, qo3mr=qo3, qsgs_tke=qtke, delp=prsl, phii=phii,
        prsi=prsi, prsik=prsik,
    )


def get_prs_fv3(phii, prsi, tgrs, qgrs):
    """GFS-mass layer thickness and inverse virtual-temperature-scaled
    geopotential thickness (reference get_prs_fv3.py)."""
    del_ = prsi[..., 1:] - prsi[..., :-1]
    del_gz = (phii[..., :-1] - phii[..., 1:]) / (
        tgrs * (1.0 + con.ZVIR * maximum(0.0, qgrs))
    )
    return del_, del_gz


def get_phi_fv3(gt0, gq0, del_gz):
    """Geopotential rebuilt from the (possibly physics-updated)
    temperature/humidity (reference get_phi_fv3.py)."""
    del_gz = del_gz * gt0 * (1.0 + con.ZVIR * maximum(0.0, gq0))
    phii_above = reverse_cumsum(del_gz)
    phii = torch.cat(
        [phii_above, torch.zeros_like(gt0[..., :1])], -1
    )
    phil = phii[..., 1:] + 0.5 * del_gz
    return phii, phil


def prepare_microphysics(phii, omga, qvapor, pt, prsl):
    """Microphysics-grid height thickness and vertical velocity
    (reference physics.py:113-146)."""
    dz = (phii[..., 1:] - phii[..., :-1]) * con.RGRAV  # negative
    wmp = (
        -omga * (1.0 + con.ZVIR * qvapor) * pt / prsl
        * (con.RDGAS * con.RGRAV)
    )
    return dz, wmp


class Physics:
    """The physics driver (API analogue of the reference Physics class) on
    `device` (the card unless the caller asks for the CPU); currently the
    microphysics package, matching the reference's
    active_packages=["microphysics"]."""

    def __init__(self, config: PhysicsConfig, area, ptop: float,
                 timestep: float, active_packages=("microphysics",),
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        area = area.to(self.device)
        self._ptop = float(ptop)
        self._pktop = (self._ptop / P00) ** con.KAPPA
        self._pk0inv = (1.0 / P00) ** con.KAPPA
        self._do_microphysics = "microphysics" in active_packages
        self.timestep = timestep
        if self._do_microphysics:
            if config.microphysics_scheme == "emulator":
                # lazily constructed on first call (needs the state's nz)
                self._microphysics = None
            elif config.microphysics_scheme == "gfdl":
                self._microphysics = Microphysics(config, area, timestep,
                                                  device=device)
            else:
                raise ValueError(
                    "microphysics_scheme must be 'gfdl' or 'emulator', "
                    f"got {config.microphysics_scheme!r}"
                )

    def __call__(self, state: PhysicsState) -> PhysicsState:
        if state.pt.device.type != self.device.type:
            raise ValueError(
                f"state on {state.pt.device}, physics on {self.device}")
        state = atmos_phys_driver_statein(
            state, self._ptop, self._pktop, self._pk0inv
        )
        delprsi, del_gz = get_prs_fv3(
            state.phii, state.prsi, state.pt, state.qvapor
        )
        # (a PBL scheme would update the state here)
        phii, phil = get_phi_fv3(state.pt, state.qvapor, del_gz)
        state = dataclasses.replace(
            state, delprsi=delprsi, phii=phii, phil=phil
        )
        if not self._do_microphysics:
            return state
        dz, wmp = prepare_microphysics(
            state.phii, state.omga, state.qvapor, state.pt, state.delp
        )
        mp_state = MicrophysicsState(
            pt=state.pt, qvapor=state.qvapor, qliquid=state.qliquid,
            qrain=state.qrain, qice=state.qice, qsnow=state.qsnow,
            qgraupel=state.qgraupel, qcld=state.qcld, ua=state.ua,
            va=state.va, delp=state.delp, delz=state.delz,
            omga=state.omga, delprsi=state.delprsi, wmp=wmp, dz=dz,
            land=state.land,
        )
        if self._microphysics is None:
            self._microphysics = MicrophysicsEmulator(
                self.config.emulator, mp_state.pt.shape[-1],
                device=self.device,
            )
        tend = self._microphysics(mp_state)
        dt = self.timestep
        return dataclasses.replace(
            state,
            dz=dz, wmp=tend["wmp"],
            physics_updated_specific_humidity=(
                state.qvapor + tend["qv_dt"] * dt
            ),
            physics_updated_qliquid=state.qliquid + tend["ql_dt"] * dt,
            physics_updated_qrain=state.qrain + tend["qr_dt"] * dt,
            physics_updated_qice=state.qice + tend["qi_dt"] * dt,
            physics_updated_qsnow=state.qsnow + tend["qs_dt"] * dt,
            physics_updated_qgraupel=state.qgraupel + tend["qg_dt"] * dt,
            physics_updated_cloud_fraction=state.qcld + tend["qa_dt"] * dt,
            physics_updated_pt=state.pt + tend["pt_dt"] * dt,
            physics_updated_ua=state.ua + tend["udt"] * dt,
            physics_updated_va=state.va + tend["vdt"] * dt,
        )
