"""Seeded numpy inputs for checking each kernel against its plain version.

The generators follow the reference package's kernel tests
(tests/test_pallas_transport.py, test_sim1_pallas.py, test_fillz_pallas.py)
and return numpy arrays, so the CPU tests can hand the same inputs to both
packages and the card checks can move them to the device.
"""

from __future__ import annotations

import numpy as np

from pace_torch.grid.generation import grid_arrays_numpy
from pace_torch.parallel.topology import get_topology

TRANSPORT_KEYS = ("q_y", "q_x", "crx", "cry", "xfx", "yfx", "xmf", "ymf",
                  "dxa", "dya", "area")


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
