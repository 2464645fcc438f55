"""The FV3 dynamical core: one full model timestep (fv_dynamics).

Port of `pace_tpu.models.fv3.dynamics` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/fv_dynamics.py `DynamicalCore`): fv_setup ->
pt to potential-density temperature -> k_split x { acoustic substeps ->
tracer advection -> vertical remapping } -> negative-tracer adjustment ->
D-grid to lat/lon winds.  The step runs eagerly on the device of its
state; the three hand-written CUDA kernels (transport, SIM1, fillz) run on
a CUDA device, their plain torch versions on the CPU.  The step carries the
reference's named savepoints (utils/checkpointer.py) and per-stage
finiteness checks (utils/debug.py); both return at once unless a
checkpointer is active or the debug switch is set.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from pace_torch.models.fv3 import acoustics
from pace_torch.models.fv3.config import DynamicalCoreConfig, get_column_namelist
from pace_torch.models.fv3.state import NQ, TRACER_NAMES, DycoreState
from pace_torch.ops import c2l_ord, moist_cv, neg_adj3, remapping
from pace_torch.ops import saturation_adjustment as satadj
from pace_torch.ops import tracer_advection as tradv
from pace_torch.ops.del2cubed import hyperdiffusion
from pace_torch.parallel import halo as halo_mod
from pace_torch.parallel.topology import get_topology
from pace_torch.utils.checkpointer import checkpoint
from pace_torch.utils.debug import nancheck
from pace_torch.utils.gridtools import GridSizing


class DynamicalCore:
    """Configures and steps the FV3 dycore on the device and dtype of its
    grid data."""

    def __init__(self, config: DynamicalCoreConfig, sizing: GridSizing,
                 grid_data, timestep: float, timer=None, topology=None):
        """With a `timer` (utils/timing.Timer), each step clocks its
        acoustic substeps, tracer advection and remap as "DynCore",
        "TracerAdvection" and "Remapping", summed over k_split.  With a
        `topology` (a `parallel.halo.RankTopology`) the grid data and the
        state hold one rank's tiles and the halo updates exchange with the
        other ranks; by default they hold the whole cube."""
        if config.hydrostatic:
            raise NotImplementedError("hydrostatic mode is not implemented")
        if config.consv_te > 0:
            raise NotImplementedError("consv_te > 0 needs a global reduction")
        self.config = config
        self.sizing = sizing
        self.grid_data = grid_data
        self.device = grid_data.device
        self.dtype = grid_data.dtype
        self.timestep = timestep
        self.timer = timer
        self.topo = (topology if topology is not None
                     else get_topology(sizing.n, sizing.halo))
        # the block of each tile this rank's fields hold
        self.domain = self.topo.domain
        self.column_namelist = get_column_namelist(config, sizing.nz)
        # in the grid's dtype, as the reference package computes them
        ak = grid_data.vertical.ak.detach().cpu().numpy()
        bk = grid_data.vertical.bk.detach().cpu().numpy()
        ph = ak + bk * 1.0e5
        self.vertical_params = dict(
            ak=ak, bk=bk, dp_ref=ph[1:] - ph[:-1],
            pfull=(ph[1:] - ph[:-1]) / np.log(ph[1:] / ph[:-1]),
        )

    def step_dynamics(self, state: DycoreState) -> DycoreState:
        if state.device != self.device or state.dtype != self.dtype:
            raise ValueError(
                f"state on {state.device}/{state.dtype}, dycore on "
                f"{self.device}/{self.dtype}")
        return fv_dynamics(
            state, self.grid_data, self.column_namelist, self.config,
            self.topo, self.timestep,
            self.vertical_params, self.timer,
        )


def _preamble(s: dict, config: DynamicalCoreConfig, dom):
    """fv_setup + pt -> potential-density temperature."""
    # reference fv_dynamics.py:321-341 _checkpoint_fvdynamics
    checkpoint("FVDynamics-In", domain=dom, u=s["u"], v=s["v"], w=s["w"],
               delp=s["delp"], pt=s["pt"], delz=s["delz"],
               qvapor=s["qvapor"])
    q_con, cvm, pkz, cappa, dp1 = moist_cv.fv_setup(
        s["qvapor"], s["qliquid"], s["qrain"], s["qsnow"], s["qice"],
        s["qgraupel"], s["pt"], s["delp"], s["delz"],
        moist_phys=config.moist_phys,
    )
    s["q_con"] = q_con
    s["pkz"] = pkz
    s["pt"] = s["pt"] * (1.0 + dp1) * (1.0 - q_con) / pkz
    nancheck("fv_setup", dom, pt=s["pt"], q_con=q_con, pkz=pkz)
    wsd = torch.zeros_like(s["ps"])
    return s, cappa, wsd


def _phase_tracer_advection(s: dict, dp_initial, gd, topo,
                            config: DynamicalCoreConfig):
    dom = topo.domain
    if not config.z_tracer:
        raise NotImplementedError("z_tracer=False")
    advected = {name: s[name] for name in TRACER_NAMES[:NQ]}
    # reference fv_dynamics.py:377-398 _checkpoint_tracer_advection
    checkpoint("Tracer2D1L-In", domain=dom, qvapor=advected["qvapor"],
               qliquid=advected["qliquid"], dp1=dp_initial,
               mfxd=s["mfxd"], mfyd=s["mfyd"])
    advected = tradv.tracer_advection(
        advected, dp_initial, s["mfxd"], s["mfyd"], s["cxd"],
        s["cyd"], gd, topo, config.hord_tr,
        dynamic_subcycle=config.dynamic_tracer_subcycle,
    )
    s.update(advected)
    nancheck("tracer_advection", dom,
             **{k: advected[k] for k in list(advected)[:3]})
    checkpoint("Tracer2D1L-Out", domain=dom, qvapor=s["qvapor"],
               qliquid=s["qliquid"], mfxd=s["mfxd"], mfyd=s["mfyd"])
    return s


def _phase_remap(s: dict, cappa, wsd, gd, config: DynamicalCoreConfig,
                 topo, last_step: bool, mdt: float, vp: dict):
    """Vertical remapping + (last step) omega."""
    dom = topo.domain
    n, h = dom.n, dom.h
    checkpoint("Remapping-In", domain=dom, pt=s["pt"], delp=s["delp"],
               delz=s["delz"], u=s["u"], v=s["v"], w=s["w"])
    tracers = {name: s[name] for name in remapping.REMAP_TRACERS}
    sat_fn = None
    if config.do_sat_adj:
        def sat_fn(dp1_b, trc, hs, peln, delp, delz, q_con_, pt, pkz_,
                   cappa_, zvir, mdt_, last_step_, akap):
            return satadj.saturation_adjustment(
                dp1_b, trc, hs, peln, delp, delz, q_con_, pt, pkz_,
                cappa_, zvir, mdt_, last_step_, akap, gd, config, n, h,
                vp=vp,
            )
    out = remapping.lagrangian_to_eulerian(
        tracers, s["pt"], s["delp"], s["delz"], s["peln"], s["u"],
        s["v"], s["w"], cappa, s["q_con"], s["pkz"], s["pk"], s["pe"],
        s["phis"], s["ps"], wsd, gd, config, n, h, last_step,
        config.consv_te, mdt, do_sat_adj_fn=sat_fn,
    )
    s.update(out["tracers"])
    for name in ("pt", "delp", "delz", "peln", "u", "v", "w", "q_con",
                 "pkz", "pk", "pe", "ps"):
        s[name] = out[name]
    cappa = out["cappa"]
    checkpoint("Remapping-Out", domain=dom, pt=s["pt"], delp=s["delp"],
               delz=s["delz"], u=s["u"], v=s["v"], w=s["w"])
    nancheck("lagrangian_to_eulerian", dom, pt=s["pt"],
             delp=s["delp"], u=s["u"], v=s["v"], w=s["w"], pkz=s["pkz"])

    if last_step:
        # omega from w, then hyperdiffuse it
        s["omga"] = s["delp"] / s["delz"] * s["w"]
        if config.nf_omega > 0:
            s["omga"] = halo_mod.halo_update_scalar(
                s["omga"], topo.scalar_spec("center")
            )
            s["omga"] = hyperdiffusion(
                s["omga"], gd, 0.18 * gd.damping.da_min, dom,
                nmax=config.nf_omega,
            )
    return s, cappa


def _postlude(s: dict, gd, topo,
              config: DynamicalCoreConfig) -> DycoreState:
    """Negative-tracer adjustment + D-grid -> lat/lon A-grid winds."""
    dom = topo.domain
    tracers = {name: s[name] for name in remapping.REMAP_TRACERS}
    tracers, s["pt"] = neg_adj3.adjust_negative_tracers(
        tracers, s["pt"], s["delp"]
    )
    s.update(tracers)
    ua, va, u, v = c2l_ord.cubed_to_latlon(
        s["u"], s["v"], gd, topo, order=config.c2l_ord
    )
    s["ua"], s["va"] = ua, va
    s["u"], s["v"] = u, v
    nancheck("cubed_to_latlon", dom, ua=ua, va=va, pt=s["pt"])
    checkpoint("FVDynamics-Out", domain=dom, u=s["u"], v=s["v"],
               w=s["w"], delp=s["delp"], pt=s["pt"], delz=s["delz"],
               qvapor=s["qvapor"])
    return DycoreState(**s)


def fv_dynamics(
    state: DycoreState, gd, col, config: DynamicalCoreConfig, topo,
    timestep: float, vp: dict, timer=None,
) -> DycoreState:
    """One dycore step of the fields of the block of `topo.domain`
    (utils/gridtools.py Domain: the whole tile, or a rank's part of it)."""
    dom = topo.domain
    def section(name):
        return (timer.clock(name) if timer is not None
                else contextlib.nullcontext())

    s = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    s, cappa, wsd = _preamble(s, config, dom)
    k_split = config.k_split
    mdt = timestep / k_split
    for k_loop in range(k_split):
        dp_initial = s["delp"]
        with section("DynCore"):
            s, cappa, wsd, _pem = acoustics.acoustic_dynamics(
                s, cappa, gd, col, config, topo, mdt, k_loop + 1, wsd,
                vp,
            )
            nancheck("acoustic_dynamics", dom, u=s["u"], v=s["v"],
                     w=s["w"], delp=s["delp"], pt=s["pt"], delz=s["delz"])
        with section("TracerAdvection"):
            s = _phase_tracer_advection(s, dp_initial, gd, topo, config)
        with section("Remapping"):
            s, cappa = _phase_remap(s, cappa, wsd, gd, config, topo,
                                    k_loop == k_split - 1, mdt, vp)
    return _postlude(s, gd, topo, config)
