"""Acoustic (Lagrangian) dynamics: the dyn_core n_split substep loop.

Port of `pace_tpu.models.fv3.acoustics` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/dyn_core.py `AcousticDynamics.__call__`
:670-969).  The reference's grouped MPI halo updaters become gather-based
halo updates on the single device.
"""

from __future__ import annotations

import torch

from pace_torch.ops import c_sw as c_sw_mod
from pace_torch.ops import d_sw as d_sw_mod
from pace_torch.ops import nh_p_grad as nhpg
from pace_torch.ops import riemann, updatedz, updatedzd
from pace_torch.ops.del2cubed import hyperdiffusion
from pace_torch.ops.stencil_utils import shift
from pace_torch.parallel import halo as halo_mod
from pace_torch.utils import constants
from pace_torch.utils.checkpointer import checkpoint

HUGE_R = 1.0e40


def get_nk_heat_dissipation(config, npz: int) -> int:
    if config.convert_ke or config.vtdm4 > 1.0e-4:
        return npz
    if config.d2_bg_k1 < 1.0e-3:
        return 0
    if config.d2_bg_k2 < 1.0e-3:
        return 1
    return 2


def _p_grad_c(uc, vc, delpc, pkc, gz, gd, dt2):
    """C-grid backward pressure-gradient force (dyn_core.py:120),
    nonhydrostatic form."""
    rdxc = gd.horizontal.rdxc[..., None]
    rdyc = gd.horizontal.rdyc[..., None]
    wk = delpc
    uc = uc + dt2 * rdxc / (shift(wk, -1) + wk) * (
        (shift(gz, -1)[..., 1:] - gz[..., :-1])
        * (pkc[..., 1:] - shift(pkc, -1)[..., :-1])
        + (shift(gz, -1)[..., :-1] - gz[..., 1:])
        * (shift(pkc, -1)[..., 1:] - pkc[..., :-1])
    )
    vc = vc + dt2 * rdyc / (shift(wk, 0, -1) + wk) * (
        (shift(gz, 0, -1)[..., 1:] - gz[..., :-1])
        * (pkc[..., 1:] - shift(pkc, 0, -1)[..., :-1])
        + (shift(gz, 0, -1)[..., :-1] - gz[..., 1:])
        * (shift(pkc, 0, -1)[..., 1:] - pkc[..., :-1])
    )
    return uc, vc


def acoustic_dynamics(
    s: dict, cappa, gd, col, config, topo,
    timestep: float, n_map: int, wsd, vp: dict,
):
    """Run n_split acoustic substeps on the fields of the block of
    `topo.domain`. `s` is a dict holding the DycoreState fields; returns
    (updated dict, cappa, wsd, heat_source diagnostics)."""
    dom = topo.domain
    end_step = n_map == config.k_split
    akap = constants.KAPPA
    dt_acoustic = timestep / config.n_split
    dt2 = 0.5 * dt_acoustic
    ptop = gd.vertical.ptop

    center = topo.scalar_spec("center")
    corner = topo.scalar_spec("corner")

    def hupd(*fields):
        return halo_mod.halo_update_scalars(topo, list(fields), "center")

    zs = s["phis"] * constants.RGRAV

    # reference column pressures (static numpy, from vp)
    dp_ref_col = vp["dp_ref"]
    pfull_col = vp["pfull"]

    # start-of-call halo updates (dyn_core.py:686-689), one grouped update
    s["q_con"], cappa, s["delp"], s["pt"] = hupd(
        s["q_con"], cappa, s["delp"], s["pt"]
    )
    s["u"], s["v"] = halo_mod.halo_update_vector(
        topo, s["u"], s["v"], "y_iface", "x_iface"
    )

    # zero accumulators
    s["mfxd"] = torch.zeros_like(s["mfxd"])
    s["mfyd"] = torch.zeros_like(s["mfyd"])
    s["cxd"] = torch.zeros_like(s["cxd"])
    s["cyd"] = torch.zeros_like(s["cyd"])
    heat_source = torch.zeros_like(s["delp"])
    if n_map == 1:
        s["diss_estd"] = torch.zeros_like(s["diss_estd"])

    gz = torch.zeros_like(s["pe"])
    zh = torch.zeros_like(s["pe"])
    pkc = torch.zeros_like(s["pe"])
    pk3 = torch.zeros_like(s["pe"])
    pem = torch.zeros_like(s["pe"])
    ut = torch.zeros_like(s["delp"])
    vt = torch.zeros_like(s["delp"])
    divgd = torch.zeros_like(s["pt"])

    n_split = config.n_split
    for it in range(n_split):
        remap_step = config.breed_vortex_inline or (it == n_split - 1)
        if it == 0:
            # gz from surface height and thicknesses (meters)
            gz = riemann.column_from_surface(zs, s["delz"])
            s["w"], gz = hupd(s["w"], gz)
        else:
            s["w"] = hupd(s["w"])[0]

        if it == n_split - 1 and end_step and config.use_old_omega:
            pem = riemann.interfaces(ptop, s["delp"])

        # C-grid half step (reference dyn_core.py:626-646 _checkpoint_csw)
        checkpoint("C_SW-In", domain=dom, delp=s["delp"], pt=s["pt"],
                   u=s["u"], v=s["v"], w=s["w"], uc=s["uc"], vc=s["vc"])
        (delpc, ptc, s["uc"], s["vc"], s["ua"], s["va"], ut, vt, divgd,
         s["omga"], s["delp"], s["pt"], s["w"]) = c_sw_mod.c_sw(
            s["delp"], s["pt"], s["u"], s["v"], s["w"], s["omga"],
            gd, dom, dt2, config.nord,
        )
        checkpoint("C_SW-Out", domain=dom, delpc=delpc, ptc=ptc,
                   uc=s["uc"], vc=s["vc"], ua=s["ua"], va=s["va"],
                   omga=s["omga"])

        if config.nord > 0:
            divgd = halo_mod.halo_update_scalar(divgd, corner)

        if it == 0:
            zh = gz  # zh tracks interface heights (m) through the loop
        else:
            gz = zh
        gz, ws3 = updatedz.update_dz_c(
            torch.as_tensor(dp_ref_col, dtype=gz.dtype, device=gz.device),
            zs, gd.horizontal.area,
            ut, vt, gz, dom, dt2,
        )
        gz, pkc = riemann.riem_solver_c(
            dt2, cappa, ptop, s["phis"], ws3, ptc, s["q_con"], delpc,
            gz, s["omga"], config.p_fac,
        )

        s["uc"], s["vc"] = _p_grad_c(s["uc"], s["vc"], delpc, pkc, gz, gd,
                                     dt2)
        s["uc"], s["vc"] = halo_mod.halo_update_vector(
            topo, s["uc"], s["vc"], "x_iface", "y_iface"
        )

        # D-grid full step (reference dyn_core.py:648-668 _checkpoint_dsw)
        checkpoint("D_SW-In", domain=dom, delp=s["delp"], pt=s["pt"],
                   u=s["u"], v=s["v"], w=s["w"], uc=s["uc"], vc=s["vc"],
                   divgd=divgd)
        out = d_sw_mod.d_sw(
            s["delp"], s["pt"], s["u"], s["v"], s["w"], s["uc"], s["vc"],
            s["ua"], s["va"], divgd, s["mfxd"], s["mfyd"], s["cxd"],
            s["cyd"], s["q_con"], heat_source, s["diss_estd"], ut, vt,
            gd, col, config, dom, dt_acoustic,
        )
        s["delp"], s["pt"] = out["delp"], out["pt"]
        s["u"], s["v"], s["w"] = out["u"], out["v"], out["w"]
        s["q_con"], divgd = out["q_con"], out["divgd"]
        s["mfxd"], s["mfyd"] = out["mfx"], out["mfy"]
        s["cxd"], s["cyd"] = out["cx"], out["cy"]
        heat_source, s["diss_estd"] = out["heat_source"], out["diss_est"]
        crx, cry, xfx, yfx = out["crx"], out["cry"], out["xfx"], out["yfx"]
        delpc = out["delpc"]
        ut, vt = out["ut"], out["vt"]
        checkpoint("D_SW-Out", domain=dom, delp=s["delp"], pt=s["pt"],
                   u=s["u"], v=s["v"], w=s["w"], mfxd=s["mfxd"],
                   mfyd=s["mfyd"])

        s["delp"], s["pt"], s["q_con"] = hupd(
            s["delp"], s["pt"], s["q_con"]
        )

        zh, wsd = updatedzd.update_dz_d(
            zs, zh, crx, cry, xfx, yfx, gd, col, config, dom,
            dt_acoustic, vp["dp_ref"],
        )
        (s["delz"], zh, s["pe"], pkc, pk3, s["pk"], s["peln"],
         s["w"]) = riemann.riem_solver3(
            dt_acoustic, cappa, ptop, zs, wsd, s["delz"], s["q_con"],
            s["delp"], s["pt"], zh, s["pe"], pk3, s["pk"], s["peln"],
            s["w"], config.p_fac, config.beta, config.use_logp,
            last_call=remap_step,
        )
        if remap_step:
            s["pe"] = nhpg.pe_halo(s["pe"], s["delp"], ptop, dom)
        pk3 = nhpg.pk3_halo(pk3, s["delp"], ptop, akap, dom)
        zh, pkc = hupd(zh, pkc)
        gz = zh * constants.GRAV

        s["u"], s["v"], pkc, gz, pk3 = nhpg.nh_p_grad(
            s["u"], s["v"], pkc, gz, pk3, s["delp"], gd, dom,
            dt_acoustic, ptop, akap,
        )

        if config.rf_fast:
            # nonhydrostatic: DynamicalCore refuses hydrostatic configs
            s["u"], s["v"], s["w"] = nhpg.ray_fast(
                s["u"], s["v"], s["w"], dp_ref_col, pfull_col, dt_acoustic,
                ptop, config.rf_cutoff, config.tau, False,
            )

        if it != n_split - 1:
            s["u"], s["v"] = halo_mod.halo_update_vector(
                topo, s["u"], s["v"], "y_iface", "x_iface"
            )
        else:
            s["u"], s["v"] = halo_mod.synchronize_vector_interfaces(
                topo, s["u"], s["v"], "y_iface", "x_iface"
            )

    nk_heat = get_nk_heat_dissipation(config, s["delp"].shape[-1])
    if nk_heat > 0:
        heat_source = hupd(heat_source)[0]
        cd = constants.CNST_0P20 * gd.damping.da_min
        # only the first nk_heat levels receive diffusion + heating
        hs_part = heat_source[..., :nk_heat]
        hs_part = hyperdiffusion(hs_part, gd, cd, dom, nmax=3)
        heat_source = torch.cat([hs_part, heat_source[..., nk_heat:]], -1)
        delt_time_factor = abs(dt_acoustic * config.delt_max)
        pt_new = nhpg.apply_diffusive_heating(
            s["delp"][..., :nk_heat], s["delz"][..., :nk_heat],
            cappa[..., :nk_heat], heat_source[..., :nk_heat],
            s["pt"][..., :nk_heat], delt_time_factor,
        )
        s["pt"] = torch.cat([pt_new, s["pt"][..., nk_heat:]], -1)

    return s, cappa, wsd, pem
