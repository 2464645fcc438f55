"""The port's fast saturation adjustment against the reference package's
on the same numpy inputs (float64, CPU); tests/test_torch_coupled.py holds
the dycore step with `do_sat_adj=True` against the reference package's.

Bar: 1e-12 of each output's scale.  The columns are built so
that every process is taken somewhere: layers from 185 K to 305 K, vapour
from 0.4 to 1.4 of saturation, every condensate present, and negative
cloud ice, snow, graupel, cloud water and rain in places (the fixers)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefConfig
from pace_tpu.ops import saturation_adjustment as ref_satadj
from pace_tpu.utils import constants as con
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.ops import saturation_adjustment as satadj
from pace_torch.testing import torch_threads

SHAPE = (2, 6, 5, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield
TRACERS = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel", "qcld")


def satadj_inputs(seed=0, shape=SHAPE):
    """numpy inputs of saturation_adjustment, keyed by argument name."""
    rng = np.random.default_rng(seed)
    nz = shape[-1]
    p_mid = np.linspace(5.0e2, 1.0e5, nz)
    dp = np.gradient(p_mid) * rng.uniform(0.9, 1.1, shape)
    t = np.linspace(185.0, 305.0, nz) + rng.uniform(-8.0, 8.0, shape)
    rho = p_mid / (con.RDGAS * t)
    delz = -dp / (con.GRAV * rho)
    es = con.E00 * np.exp(
        (con.DC_VAP * np.log(t / con.TICE)
         + con.LV0 * (t - con.TICE) / (t * con.TICE)) / con.RVGAS)
    qsat = es / (con.RVGAS * t * rho)
    tr = {"qvapor": np.minimum(qsat * rng.uniform(0.4, 1.4, shape), 0.03)}
    for name, top in (("qliquid", 3e-3), ("qice", 3e-4), ("qrain", 1e-3),
                      ("qsnow", 1e-3), ("qgraupel", 1e-3)):
        q = top * rng.uniform(0.0, 1.0, shape) ** 3
        q[rng.uniform(size=shape) < 0.3] = 0.0
        neg = rng.uniform(size=shape) < 0.1
        q[neg] = -1e-6 * rng.uniform(size=int(neg.sum()))
        tr[name] = q
    tr["qcld"] = rng.uniform(0.0, 1.0, shape)
    tr["qo3mr"] = np.full(shape, 1e-6)
    qpz = sum(tr[k] for k in TRACERS[1:6])
    pt = t * (1.0 + con.ZVIR * tr["qvapor"]) * (1.0 - qpz)
    return dict(
        dp1=dp, tracers=tr, hs=rng.uniform(0.0, 3.0e3, shape[:3]),
        peln=np.zeros(shape[:3] + (nz + 1,)), delp=dp, delz=delz,
        q_con=qpz, pt=pt, pkz=rng.uniform(0.3, 1.0, shape),
        cappa=rng.uniform(0.27, 0.29, shape),
        area=rng.uniform(1.0e9, 4.0e10, shape[:3]),
        pfull=p_mid,
    )


def _call(mod, xp, inp, config, last_step, mdt=112.5):
    gd = types.SimpleNamespace(
        horizontal=types.SimpleNamespace(area=xp(inp["area"])))
    out = mod.saturation_adjustment(
        xp(inp["dp1"]), {k: xp(v) for k, v in inp["tracers"].items()},
        xp(inp["hs"]), xp(inp["peln"]), xp(inp["delp"]), xp(inp["delz"]),
        xp(inp["q_con"]), xp(inp["pt"]), xp(inp["pkz"]), xp(inp["cappa"]),
        con.ZVIR, mdt, last_step, con.KAPPA, gd, config, 0, 0,
        vp=dict(pfull=inp["pfull"]),
    )
    tracers, q_con, pt, pkz, cappa = out[:5]
    flat = {k: np.asarray(v) for k, v in tracers.items()}
    flat.update(q_con=np.asarray(q_con), pt=np.asarray(pt),
                pkz=np.asarray(pkz), cappa=np.asarray(cappa))
    return flat


def assert_close(got: dict, ref: dict, tol: float, label=""):
    bad = {}
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        scale = float(np.abs(r).max()) + 1e-300
        err = float(np.abs(g - r).max()) / scale
        if not err <= tol:
            bad[name] = err
    assert not bad, (label, bad)


@pytest.mark.parametrize("last_step", [False, True])
@pytest.mark.parametrize("settings", [
    {}, {"icloud_f": 1}, {"icloud_f": 2, "tintqs": True},
    {"rad_snow": False, "rad_rain": False},
], ids=["default", "icloud_f1", "icloud_f2_tintqs", "no_rad_snow_rain"])
def test_saturation_adjustment_matches_reference(last_step, settings):
    inp = satadj_inputs()
    ref = _call(ref_satadj, jnp.asarray, inp, RefConfig(**settings), last_step)
    got = _call(satadj, lambda a: torch.tensor(a, dtype=torch.float64), inp,
                DynamicalCoreConfig(**settings), last_step)
    for name in ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel",
                 "pt"):
        assert np.abs(ref[name] - inp["tracers"].get(name, inp["pt"])).max() \
            > 0, name
    if last_step:
        assert np.abs(ref["qcld"] - inp["tracers"]["qcld"]).max() > 0
    assert_close(got, ref, 1e-12)


def test_levels_above_10_hpa_are_left_alone():
    inp = satadj_inputs(seed=1)
    got = _call(satadj, lambda a: torch.tensor(a, dtype=torch.float64), inp,
                DynamicalCoreConfig(), True)
    kmp = int(np.argmax(inp["pfull"] > 10.0e2))
    assert kmp > 0
    np.testing.assert_array_equal(got["pt"][..., :kmp], inp["pt"][..., :kmp])
    assert np.abs(got["pt"][..., kmp:] - inp["pt"][..., kmp:]).max() > 0


@pytest.mark.parametrize("kind", ["w", "i2"])
def test_es_and_ddt_matches_reference(kind):
    t = np.linspace(100.0, 400.0, 3001)
    den = np.full_like(t, 1.1)
    ref = ref_satadj._wqs2(jnp.asarray(t), jnp.asarray(den), kind)
    got = satadj._wqs2(torch.tensor(t), torch.tensor(den), kind)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)
    np.testing.assert_allclose(
        satadj._wqs1(torch.tensor(t), torch.tensor(den), kind).numpy(),
        np.asarray(ref_satadj._wqs1(jnp.asarray(t), jnp.asarray(den), kind)),
        rtol=1e-13)
