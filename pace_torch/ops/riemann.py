"""Semi-implicit nonhydrostatic vertical solvers (SIM1 / Riem_Solver_C / _3).

Port of `pace_tpu.ops.riemann` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/sim1_solver.py, riem_solver_c.py,
riem_solver3.py).  All tensors carry k LAST: layer fields (..., nz),
interface fields (..., nz+1).

`sim1_solver` runs the plain scan form (`sim1_solver_plain`, loops over
k on whole horizontal slabs) for a CPU tensor and the column-block CUDA
kernel of csrc/sim1.cu for a CUDA tensor; the kernel replaces
`pace_tpu.ops.pallas.sim1_pallas.sim1_pallas`.
"""

from __future__ import annotations

import math

import torch

from pace_torch.ops import bounds
from pace_torch.ops.stencil_utils import cumsum_k, reverse_cumsum
from pace_torch.utils import constants

# Launches of the CUDA SIM1 kernel; read and reset by chip_smoke.py.
LAUNCHES = 0


def sim1_solver_plain(w, dm, gm, dz, pt, pm, pem, ws, dt, p_fac):
    """Tridiagonal solve for w and dz (sound waves + vertical PGF), the scan
    form of the reference package.

    Args (layer fields (..., nz) except pem (..., nz+1), ws (...)):
        w: vertical velocity; dm: layer mass per unit area; gm: 1/(1-cappa);
        dz: layer thickness (negative); pt: temperature; pm: layer-mean
        hydrostatic pressure; pem: interface hydrostatic pressure;
        ws: surface vertical wind from terrain.
    Returns (w, dz, pe) with pe the nonhydrostatic perturbation pressure on
    interfaces (..., nz+1).
    """
    t1g = 2.0 * dt * dt
    rdt = 1.0 / dt
    nz = w.shape[-1]

    pe_l = torch.exp(gm * torch.log(-dm / dz * constants.RDGAS * pt)) - pm
    g_rat = dm[..., :-1] / dm[..., 1:]
    bb = torch.cat([2.0 * (1.0 + g_rat), torch.full_like(g_rat[..., :1], 2.0)],
                   -1)
    dd = torch.cat([3.0 * (pe_l[..., :-1] + g_rat * pe_l[..., 1:]),
                    3.0 * pe_l[..., -1:]], -1)
    grat = torch.cat([g_rat, torch.zeros_like(g_rat[..., :1])], -1)

    # forward elimination for pp, k = 1..nz
    pp = [torch.zeros_like(w[..., 0])]
    gam = [torch.zeros_like(w[..., 0])]
    bet = bb[..., 0]
    for k in range(1, nz + 1):
        gam_k = grat[..., k - 1] / bet
        pp.append((dd[..., k - 1] - pp[k - 1]) / bet)
        gam.append(gam_k)
        bet = bb[..., min(k, nz - 1)] - gam_k
    # backward substitution: pp_k -= gam_k * pp_{k+1}, k = nz-1..1
    for k in range(nz - 1, 0, -1):
        pp[k] = pp[k] - gam[k] * pp[k + 1]

    aa = [None] + [
        t1g * 0.5 * (gm[..., k - 1] + gm[..., k]) / (dz[..., k - 1]
                                                     + dz[..., k])
        * (pem[..., k] + pp[k])
        for k in range(1, nz)
    ]
    p1_last = t1g * gm[..., nz - 1] / dz[..., nz - 1] * (pem[..., nz]
                                                        + pp[nz])

    # w solve, forward, with the surface coupling at k = nz-1
    bet = dm[..., 0] - aa[1]
    wk = [(dm[..., 0] * w[..., 0] + dt * pp[1]) / bet]
    gam2 = [None]
    for k in range(1, nz):
        last = k == nz - 1
        aak = aa[k]
        aak1 = p1_last if last else aa[k + 1]
        gam2_k = aak / bet
        bet = dm[..., k] - (aak + aak1 + aak * gam2_k)
        rhs = dm[..., k] * w[..., k] + dt * (pp[k + 1] - pp[k])
        if last:
            rhs = rhs - p1_last * ws
        wk.append((rhs - aak * wk[k - 1]) / bet)
        gam2.append(gam2_k)
    for k in range(nz - 2, -1, -1):
        wk[k] = wk[k] - gam2[k + 1] * wk[k + 1]
    w_out = torch.stack(wk, -1)

    # pe on interfaces: running sum of mass-weighted dw
    dwe = dm * (w_out - w) * rdt
    pe = [torch.zeros_like(w[..., 0])]
    for k in range(nz):
        pe.append(pe[k] + dwe[..., k])

    # p1 backward recurrence for the dz update
    p1 = [None] * nz
    p1[nz - 1] = (pe[nz - 1] + 2.0 * pe[nz]) / 3.0
    for k in range(nz - 2, -1, -1):
        p1[k] = (pe[k] + bb[..., k] * pe[k + 1] + grat[..., k] * pe[k + 2]) \
            / 3.0 - grat[..., k] * p1[k + 1]
    p1 = torch.stack(p1, -1)

    cp3 = 1.0 - 1.0 / gm
    maxp = torch.where(p_fac * dm > p1 + pm, p_fac * pm, p1 + pm)
    dz_out = -dm * constants.RDGAS * pt * torch.exp((cp3 - 1.0)
                                                    * torch.log(maxp))
    return w_out, dz_out, torch.stack(pe, -1)


def sim1_solver_cuda(w, dm, gm, dz, pt, pm, pem, ws, dt, p_fac):
    """The SIM1 solve as one launch of the CUDA kernel (same arguments and
    results as sim1_solver_plain; layer fields (6, Ni, Nj, nz))."""
    global LAUNCHES
    from pace_torch.ops import _cuda

    shape = tuple(w.shape)
    nz = shape[-1]
    if nz < 3:
        raise ValueError("the SIM1 kernel needs at least 3 levels")
    _cuda.check(w, dm, gm, dz, pt, pm, shape=shape, dtype=w.dtype)
    _cuda.check(pem, shape=shape[:-1] + (nz + 1,), dtype=w.dtype)
    _cuda.check(ws, shape=shape[:-1], dtype=w.dtype)
    w_out, dz_out = torch.empty_like(w), torch.empty_like(w)
    pe_out = torch.empty_like(pem)
    _cuda.launch("sim1", w.dtype, w, dm, gm, dz, pt, pm, pem, ws, w_out,
                 dz_out, pe_out, ints=(w.numel() // nz, nz),
                 floats=(dt, p_fac))
    LAUNCHES += 1
    return w_out, dz_out, pe_out


def sim1_solver(w, dm, gm, dz, pt, pm, pem, ws, dt, p_fac):
    """SIM1 solve; a CPU tensor takes the plain version, a CUDA tensor the
    kernel.  See sim1_solver_plain for the arguments."""
    args = (w, dm, gm, dz, pt, pm, pem, ws)
    with bounds.kernel_call("K-S") as report:
        if w.is_cuda:
            out = sim1_solver_cuda(*args, dt, p_fac)
        else:
            out = sim1_solver_plain(*args, dt, p_fac)
        report(args, out, w.numel())
    return out


def interfaces(top: float, layers: torch.Tensor) -> torch.Tensor:
    """[top, top + cumsum(layers)] along k."""
    return torch.cat([torch.full_like(layers[..., :1], top),
                      top + cumsum_k(layers)], -1)


def column_from_surface(surface, dz, scale=None):
    """Interface heights [surface - sum_{m>=k} dz_m (*scale), surface]."""
    below = reverse_cumsum(dz)
    if scale is not None:
        below = below * scale
    return torch.cat([surface[..., None] - below, surface[..., None]], -1)


def riem_solver_c(dt2, cappa, ptop, hs, ws, ptc, q_con, delpc, gz, w3,
                  p_fac):
    """C-grid nonhydrostatic vertical solver (Riem_Solver_C).

    Args (layer fields (..., nz); gz (..., nz+1); hs/ws (...)):
    Returns (gz, pef): updated interface heights and full pressure.
    """
    dm = delpc
    pem = interfaces(ptop, dm)
    peg = interfaces(ptop, dm * (1.0 - q_con))
    dz = gz[..., 1:] - gz[..., :-1]
    gm = 1.0 / (1.0 - cappa)
    dm = dm / constants.GRAV
    pm = (peg[..., 1:] - peg[..., :-1]) / torch.log(peg[..., 1:]
                                                    / peg[..., :-1])

    w, dz, pe = sim1_solver(w3, dm, gm, dz, ptc, pm, pem, ws, dt2, p_fac)

    pef = torch.cat([torch.full_like(pe[..., :1], ptop),
                     pe[..., 1:] + pem[..., 1:]], -1)
    return column_from_surface(hs, dz, constants.GRAV), pef


def riem_solver3(dt, cappa, ptop, zs, ws, delz, q_con, delp, pt, zh, pe,
                 pk3, pk, peln, w, p_fac, beta, use_logp, last_call: bool):
    """D-grid full-timestep nonhydrostatic vertical solver (Riem_Solver3).

    Args: layer fields (..., nz): cappa, delz, q_con, delp, pt, w;
    interface fields (..., nz+1): zh, pe, pk3, pk, peln; zs/ws (...).
    Returns (delz, zh, pe, ppe, pk3, pk, peln, w).
    """
    peln1 = math.log(ptop)
    ptk = math.exp(constants.KAPPA * peln1)

    dm = delp
    p_if = interfaces(ptop, dm)
    log_p_if = torch.cat([torch.full_like(dm[..., :1], peln1),
                          torch.log(p_if[..., 1:])], -1)
    p_if_gas = interfaces(ptop, dm * (1.0 - q_con))
    log_p_if_gas = torch.cat([torch.full_like(dm[..., :1], peln1),
                              torch.log(p_if_gas[..., 1:])], -1)
    pk3_new = torch.cat([torch.full_like(dm[..., :1], ptk),
                         torch.exp(constants.KAPPA * log_p_if[..., 1:])], -1)
    gm = 1.0 / (1.0 - cappa)
    dm = dm * constants.RGRAV
    p_gas = (p_if_gas[..., 1:] - p_if_gas[..., :-1]) / (
        log_p_if_gas[..., 1:] - log_p_if_gas[..., :-1]
    )
    dz = zh[..., 1:] - zh[..., :-1]

    w_new, dz_new, pe_pert = sim1_solver(
        w, dm, gm, dz, pt, p_gas, p_if, ws, dt, p_fac
    )

    pk3_out = log_p_if if use_logp else pk3_new
    ppe = pe_pert + p_if if beta < -0.1 else pe_pert
    if last_call:
        peln_out, pk_out, pe_out = log_p_if, pk3_out, p_if
    else:
        peln_out, pk_out, pe_out = peln, pk, pe
    zh_new = column_from_surface(zs, dz_new)
    return dz_new, zh_new, pe_out, ppe, pk3_out, pk_out, peln_out, w_new
