"""Lagrangian-to-Eulerian vertical remapping.

Port of `pace_tpu.ops.remapping` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/remapping.py `LagrangianToEulerian`) for the
kord_tm < 0, nonhydrostatic configuration.  The negative-tracer fill of
the nine remapped tracers is one stacked `fillz.fix_tracers` call (the
CUDA kernel on the card).
"""

from __future__ import annotations

import torch

from pace_torch.ops import fillz as fillz_mod
from pace_torch.ops import moist_cv
from pace_torch.ops.map_single import map_single, map_single_spaces
from pace_torch.ops.stencil_utils import shift
from pace_torch.utils import constants

CONSV_MIN = 0.001
T_MIN = 184.0

REMAP_TRACERS = (
    "qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel", "qo3mr",
    "qsgs_tke", "qcld",
)


def lagrangian_to_eulerian(
    tracers: dict, pt, delp, delz, peln, u, v, w, cappa, q_con, pkz, pk, pe,
    hs, ps, wsd, gd, config, n, h, last_step: bool, consv_te: float,
    mdt: float, do_sat_adj_fn=None,
):
    """Returns a dict of the updated fields."""
    akap = constants.KAPPA
    zvir = constants.ZVIR
    ptop = gd.vertical.ptop
    ak = gd.vertical.ak.to(pt.dtype)
    bk = gd.vertical.bk.to(pt.dtype)
    nz = pt.shape[-1]
    kord_tm = abs(config.kord_tm)
    kord_tr = abs(config.kord_tr)

    dp1_before = delp  # saved for saturation adjustment

    pe1 = pe
    # virtual temperature + condensate bookkeeping (moist_cv_pt_pressure)
    cvm, gz, q_con, cappa, pt = moist_cv.moist_pt(
        tracers["qvapor"], tracers["qliquid"], tracers["qrain"],
        tracers["qsnow"], tracers["qice"], tracers["qgraupel"],
        pt, delp, delz, zvir,
    )
    delz = -delz / delp
    ps = pe[..., -1]
    # Eulerian target interface pressures
    pe2 = torch.cat(
        [
            torch.full_like(pe[..., :1], ptop),
            ak[1:nz] + bk[1:nz] * ps[..., None],
            pe[..., -1:],
        ], -1,
    )
    dp2 = pe2[..., 1:] - pe2[..., :-1]
    pn2 = torch.log(pe2)
    delp_new = dp2
    pk_layers = torch.exp(akap * pn2[..., :-1])
    pk = torch.cat([pk_layers, pk[..., -1:]], -1)

    # tracers (negative-value filling applied after), w, delz AND pt share
    # one source-layer index: pt remaps in log-pressure (reference
    # remapping.py map_scalar), but log is monotone so its source layers
    # are those of the linear pressures.  (All tracer kords are equal for
    # supported configs: reference mapn_tracer.py sets kord_tracer[5]=9.)
    stacked = torch.stack([tracers[name] for name in REMAP_TRACERS])
    (stacked, w, delz), (pt,) = map_single_spaces(
        [
            (pe1, pe2, [
                (stacked, kord_tr, 0, None, 0.0),
                (w, config.kord_wz, -2, wsd, 0.0),
                (delz, config.kord_wz, 1, None, 0.0),
            ]),
            (peln, pn2, [(pt, kord_tm, 1, None, T_MIN)]),
        ],
        n, h,
    )
    if config.fill:
        stacked = fillz_mod.fix_tracers(stacked, dp2)
    new_tracers = dict(tracers)
    for i, name in enumerate(REMAP_TRACERS):
        new_tracers[name] = stacked[i]
    tracers = new_tracers

    delz = -delz * delp_new
    peln_new = pn2
    delp = delp_new

    q_con, gz, cvm, cappa, pkz = moist_cv.moist_pkz(
        tracers["qvapor"], tracers["qliquid"], tracers["qrain"],
        tracers["qsnow"], tracers["qice"], tracers["qgraupel"],
        pt, delp, delz, zvir,
    )

    # u remap: pressures averaged to y-interface points
    pe_bot = pe1[..., -1:]
    pe0_u = torch.cat(
        [pe1[..., :1], 0.5 * (shift(pe1, 0, -1)[..., 1:] + pe1[..., 1:])], -1
    )
    pe3_u = ak + 0.5 * bk * (shift(pe_bot, 0, -1) + pe_bot)
    u = map_single(u, pe0_u, pe3_u, n, h, config.kord_mt, -1)

    # v remap: pressures averaged to x-interface points
    pe0_v = torch.cat(
        [pe1[..., :1], 0.5 * (shift(pe1, -1)[..., 1:] + pe1[..., 1:])], -1
    )
    pe3_v = torch.cat(
        [
            torch.broadcast_to(ak[0], pe1[..., :1].shape),
            (ak + 0.5 * bk * (shift(pe_bot, -1) + pe_bot))[..., 1:],
        ], -1,
    )
    v = map_single(v, pe0_v, pe3_v, n, h, config.kord_mt, -1)

    pe = torch.cat([pe[..., :1], pe2[..., 1:]], -1)

    dtmp = 0.0
    if last_step and abs(consv_te) > CONSV_MIN:
        raise NotImplementedError("consv_te > CONSV_MIN requires allreduce")

    if config.do_sat_adj and do_sat_adj_fn is not None:
        (tracers, q_con, pt, pkz, cappa, delp, delz, peln_new) = do_sat_adj_fn(
            dp1_before, tracers, hs, peln_new, delp, delz, q_con, pt, pkz,
            cappa, zvir, mdt, last_step, akap,
        )

    if last_step:
        gz, pt = moist_cv.moist_pt_last_step(
            tracers["qvapor"], tracers["qliquid"], tracers["qrain"],
            tracers["qsnow"], tracers["qice"], tracers["qgraupel"],
            pt, pkz, dtmp, zvir,
        )
    else:
        pt = pt / pkz

    return dict(
        tracers=tracers, pt=pt, delp=delp, delz=delz, peln=peln_new, u=u,
        v=v, w=w, cappa=cappa, q_con=q_con, pkz=pkz, pk=pk, pe=pe, ps=ps,
    )
