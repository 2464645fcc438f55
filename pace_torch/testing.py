"""Seeded numpy inputs for checking each kernel against its plain version
and each physics module against the reference package's.

The generators follow the reference package's tests
(tests/test_pallas_transport.py, test_sim1_pallas.py, test_fillz_pallas.py,
test_microphysics.py, test_fv_subgridz.py) and return numpy arrays, so the
CPU tests can hand the same inputs to both packages and the card checks can
move them to the device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from pace_torch.grid.generation import grid_arrays_numpy
from pace_torch.ops.fv_subgridz import TRACERS as SUBGRIDZ_TRACERS
from pace_torch.parallel.topology import get_topology
from pace_torch.utils import constants as con

TRANSPORT_KEYS = ("q_y", "q_x", "crx", "cry", "xfx", "yfx", "xmf", "ymf",
                  "dxa", "dya", "area")


@contextlib.contextmanager
def torch_threads(n: int):
    """Run a block with torch's CPU thread count set to `n`.  The level
    loops of the physics issue thousands of small operations; with several
    test workers on one machine the default of one thread a core
    oversubscribes it many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


_C12_RUNS = {}


def c12_dycore_run(dtype=torch.float64, steps: int = 1):
    """(sizing, dycore, [initial state, state after step 1, ...]) of the
    port's C12/79 baroclinic-wave dycore on the CPU with the settings of
    the reference's golden digests (tests/golden/c12_dycore_digest.json:
    dt 225 s, do_sat_adj=False, the other settings the defaults).  The
    steps are taken once per process and dtype, as far as any caller has
    asked, on one torch thread, so that every caller gets the same bits
    whatever its own thread count and whichever file asked first; each
    call returns copies of the states, so the test files one process runs
    share the steps and cannot change each other's."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    if dtype not in _C12_RUNS:
        sizing = GridSizing(12, 79)
        gd = generate_grid_data(12, 79, device="cpu", dtype=dtype)
        core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False), sizing,
                             gd, timestep=225.0)
        _C12_RUNS[dtype] = (sizing, core, [init_baroclinic_state(
            sizing, device="cpu", dtype=dtype)])
    sizing, core, states = _C12_RUNS[dtype]
    with torch_threads(1):
        while len(states) <= steps:
            states.append(core.step_dynamics(states[-1]))
    copies = [state.replace(**{name: tensor.clone() for name, tensor
                               in vars(state).items()})
              for state in states[:steps + 1]]
    return sizing, core, copies


def _smooth(rng, shape, scale):
    """Band-limited random field: the PPM limiter branches stay exercised
    but values are physical-ish."""
    sm = rng.standard_normal(shape)
    for ax in (1, 2):
        sm = 0.5 * sm + 0.25 * (np.roll(sm, 1, ax) + np.roll(sm, -1, ax))
    return scale * sm


def transport_inputs(n: int, nz: int, T: int, seed: int = 7,
                     halo: int = 3) -> dict:
    """Inputs of the batched transport on a C`n` grid, built the way tracer
    advection builds them: corner-composed halo gathers for q_y / q_x and
    Courant-scaled area and mass fluxes.  float64 numpy, keyed by
    TRANSPORT_KEYS."""
    hz = grid_arrays_numpy(n, 79, halo)["horizontal"]
    topo = get_topology(n, halo)
    rng = np.random.default_rng(seed)
    shape = (6, topo.N, topo.N, nz)
    crx = _smooth(rng, shape, 0.35)
    cry = _smooth(rng, shape, 0.35)
    xfx = crx * hz["dxa"][..., None] * hz["dy"][..., None]
    yfx = cry * hz["dya"][..., None] * hz["dx"][..., None]
    xmf = xfx * (1.0 + _smooth(rng, shape, 0.05))
    ymf = yfx * (1.0 + _smooth(rng, shape, 0.05))
    stacked = np.stack(
        [1.0 + np.abs(_smooth(rng, shape, 0.5)) for _ in range(T)])
    spec_y, spec_x = topo.scalar_corner_specs()
    q_y = np.ascontiguousarray(
        stacked[:, spec_y.src_tile, spec_y.src_i, spec_y.src_j])
    q_x = np.ascontiguousarray(
        stacked[:, spec_x.src_tile, spec_x.src_i, spec_x.src_j])
    return dict(q_y=q_y, q_x=q_x, crx=crx, cry=cry, xfx=xfx, yfx=yfx,
                xmf=xmf, ymf=ymf, dxa=hz["dxa"], dya=hz["dya"],
                area=hz["area"])


def sim1_inputs(ni: int, nj: int, nz: int, seed: int = 7):
    """Physically plausible SIM1 inputs (positive masses, negative dz):
    (w, dm, gm, dz, pt, pm, pem, ws), float64 numpy."""
    rng = np.random.RandomState(seed)
    shape = (6, ni, nj, nz)
    dm = 10.0 + rng.rand(*shape) * 5.0
    cappa = 0.28 + 0.01 * rng.rand(*shape)
    gm = 1.0 / (1.0 - cappa)
    dz = -(200.0 + 100.0 * rng.rand(*shape))
    pt = 250.0 + 40.0 * rng.rand(*shape)
    pm = 5e4 + 1e4 * rng.rand(*shape)
    pem = np.concatenate(
        [np.full((6, ni, nj, 1), 300.0),
         300.0 + np.cumsum(900.0 + 100.0 * rng.rand(*shape), -1)], -1,
    )
    w = rng.randn(*shape)
    ws = 0.1 * rng.randn(6, ni, nj)
    return w, dm, gm, dz, pt, pm, pem, ws


def fillz_inputs(T: int, ni: int, nj: int, nz: int, seed: int = 9,
                 neg_frac: float = 0.3):
    """A (T, 6, ni, nj, nz) tracer stack sprinkled with negatives and a
    shared positive dp (6, ni, nj, nz), float64 numpy."""
    rng = np.random.RandomState(seed)
    shape = (T, 6, ni, nj, nz)
    q = rng.rand(*shape)
    q[rng.rand(*shape) < neg_frac] *= -0.5
    dp = 300.0 + 1500.0 * rng.rand(*shape[1:])
    return q, dp


def plant_fillz_hazards(q, dp):
    """Copies of fillz inputs with the values planted that make the plain
    version's whole-array arithmetic non-finite in a column without
    negatives: a zero, infinite or NaN dp (a zero borrow divided by dp at
    every level), and a NaN or infinite q.  Each hazard goes into a column
    of its own (three columns a hazard), made non-negative in every tracer
    first, at a random level (and a zero dp also at the levels the borders
    treat apart: 0, nz-2, nz-1)."""
    rng = np.random.RandomState(11)
    q, dp = q.copy(), dp.copy()
    T, nz = q.shape[0], q.shape[-1]
    qc, dpc = q.reshape(T, -1, nz), dp.reshape(-1, nz)
    hazards = [("dp", 0.0, None), ("dp", np.inf, None), ("dp", np.nan, None),
               ("q", np.nan, None), ("q", np.inf, None),
               ("dp", 0.0, 0), ("dp", 0.0, nz - 2), ("dp", 0.0, nz - 1),
               ("q", np.nan, 0)]
    cols = rng.choice(dpc.shape[0], size=3 * len(hazards),
                      replace=False)
    for i, col in enumerate(cols):
        field, value, level = hazards[i % len(hazards)]
        k = rng.randint(nz) if level is None else level
        qc[:, col] = np.abs(qc[:, col])
        if field == "dp":
            dpc[col, k] = value
        else:
            qc[rng.randint(T), col, k] = value
    return q, dp


def microphysics_inputs(shape=(4, 3, 24), seed: int = 3, supersat_k=None,
                        cold: bool = False) -> dict:
    """A MicrophysicsState's fields as float64 numpy: a sounding from 200 to
    1000 hPa and 215 to 300 K with per-column perturbations, vapour at 0.8
    of saturation (1.3 at level `supersat_k`), cloud water and rain in the
    warm layers and cloud ice, snow and graupel in the cold ones, a few
    negative condensates for the fixer, land fraction 0 or 1 by column.
    `cold` makes every layer subfreezing and fills it with supercooled
    rain."""
    rng = np.random.default_rng(seed)
    nz = shape[-1]
    p_mid = np.linspace(2.0e4, 1.0e5, nz)
    dp = np.gradient(p_mid) * rng.uniform(0.95, 1.05, shape)
    t = np.linspace(215.0, 300.0, nz) + rng.uniform(-3.0, 3.0, shape)
    if cold:
        t = np.minimum(t, 258.0 + rng.uniform(-2.0, 2.0, shape))
    rho = p_mid / (con.RDGAS * t)
    dz = -dp / (con.GRAV * rho)
    es = con.E00 * np.exp(
        (con.DC_VAP * np.log(t / con.TICE)
         + con.LV0 * (t - con.TICE) / (t * con.TICE)) / con.RVGAS)
    qsat = es / (con.RVGAS * t * rho)
    qv = 0.8 * qsat
    if supersat_k is not None:
        qv[..., supersat_k] = 1.3 * qsat[..., supersat_k]
    warm, frozen = t > 273.16, t < 260.0
    ql = np.where(warm, 1.2e-4, 0.0) * rng.uniform(0.5, 1.5, shape)
    qr = np.where(warm, 8.0e-5, 0.0) * rng.uniform(0.5, 1.5, shape)
    qi = np.where(frozen, 5.0e-5, 0.0) * rng.uniform(0.5, 1.5, shape)
    qs = np.where(frozen, 2.0e-5, 0.0) * rng.uniform(0.5, 1.5, shape)
    qg = np.where(frozen, 1.0e-5, 0.0) * rng.uniform(0.5, 1.5, shape)
    if cold:
        qr = 2.0e-4 * rng.uniform(0.5, 1.5, shape)
    for q in (ql, qr, qi, qs, qg):
        q[rng.uniform(size=shape) < 0.03] = -1.0e-7
    return dict(
        pt=t, qvapor=qv, qliquid=ql, qrain=qr, qice=qi, qsnow=qs,
        qgraupel=qg, qcld=np.zeros(shape),
        ua=5.0 + rng.standard_normal(shape),
        va=-3.0 + rng.standard_normal(shape),
        delp=dp, delz=dz, omga=np.zeros(shape), delprsi=dp,
        wmp=0.01 * rng.standard_normal(shape), dz=dz,
        land=(rng.uniform(size=shape[:-1]) < 0.5).astype(np.float64),
    )


def subgridz_inputs(unstable: bool = True, shape=(3, 2, 30),
                    seed: int = 5) -> dict:
    """The fields `dry_convective_adjustment` reads, float64 numpy: a column
    whose potential temperature falls with height (warm under cold air:
    convectively unstable) or rises with it, sheared winds and small random
    tracers, perturbed per column."""
    rng = np.random.default_rng(seed)
    nz = shape[-1]
    p_mid = np.linspace(1.0e3, 9.5e4, nz)
    dp = np.gradient(p_mid) * rng.uniform(0.95, 1.05, shape)
    theta = (np.linspace(340.0, 420.0, nz) if unstable
             else np.linspace(420.0, 340.0, nz))
    theta = theta + rng.uniform(-2.0, 2.0, shape)
    pkz = (p_mid / 1.0e5) ** con.KAPPA * np.ones(shape)
    t = theta * pkz
    rho = p_mid / (con.RDGAS * t)
    dz = -dp / (con.GRAV * rho)
    pe = np.concatenate(
        [np.full(shape[:-1] + (1,), 500.0), 500.0 + np.cumsum(dp, -1)], -1)
    s = dict(
        pt=t, delp=dp, delz=dz, pkz=pkz, peln=np.log(pe), pe=pe,
        ua=np.linspace(30.0, -5.0, nz) + rng.standard_normal(shape),
        va=rng.standard_normal(shape), w=0.1 * rng.standard_normal(shape),
    )
    for name in SUBGRIDZ_TRACERS:
        s[name] = 1.0e-5 * rng.uniform(0.0, 1.0, shape)
    return s


def state_digest(state, sizing) -> dict:
    """Moments and strided samples of every field's compute domain, the
    digest form of the reference package's committed golden files
    (tests/golden/make_golden.py)."""
    import dataclasses

    h, n = sizing.halo, sizing.n
    digest = {}
    for f in dataclasses.fields(state):
        a = np.asarray(getattr(state, f.name).detach().cpu().numpy(),
                       dtype=np.float64)
        if a.ndim >= 3:
            a = a[:, h:h + n, h:h + n]
        flat = a.ravel()
        samples = flat[:: max(1, flat.size // 64)][:64]
        digest[f.name] = dict(
            mean=float(flat.mean()), std=float(flat.std()),
            min=float(flat.min()), max=float(flat.max()),
            samples=[float(x) for x in samples],
        )
    return digest


def digest_errors(got: dict, ref: dict) -> dict:
    """Per field: the largest |got - ref| over the four moments and the
    samples, relative to the reference field's scale max(|min|, |max|)."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        scale = max(abs(r["max"]), abs(r["min"]), 1e-30)
        err = max(abs(g[s] - r[s]) for s in ("mean", "std", "min", "max"))
        err = max(err, float(np.max(np.abs(
            np.asarray(g["samples"]) - np.asarray(r["samples"])))))
        out[name] = err / scale
    return out
