"""The port's GFDL microphysics against the reference package's on the same
numpy inputs (float64, CPU): every entry of the tendency dict within 1e-12
of its scale, for columns with a supersaturated layer, an all-subfreezing
column of supercooled rain, and the scheme's options; the recurrences
along k (implicit fall, sedimentation heating) on their own; and the
conservation law the reference's tests hold the scheme to.

Two groups of outputs are differences of nearly equal numbers and are held
to 1e-12 of the scale of what is subtracted, not of the remainder: the four
surface precipitation amounts are the last entry of cumsum(q dp - qm), so
where nothing reaches the ground they hold the round-off of the column's
mass (about 5e-15 mm/day beside 26 mm/day of rain) and share the scale of
the largest of the four; udt and vdt are (u1 - u0) / dt and take the scale
of u1 / dt."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.physics import microphysics as ref_mp
from pace_tpu.models.physics.config import PhysicsConfig as RefConfig
from pace_torch.models.physics import microphysics as mp
from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.testing import microphysics_inputs, torch_threads
from pace_torch.utils import constants as con

DT = 225.0
PRECIPITATION = ("rain", "snow", "ice", "graupel")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield
AREA = np.array([[1.0e10, 4.0e8, 2.5e9], [1.0e9, 6.0e10, 1.0e10],
                 [3.0e9, 1.0e10, 1.0e8], [1.0e10, 2.0e9, 5.0e9]])

CASES = {
    "supersaturated": (dict(supersat_k=18), {}),
    "cold_rain": (dict(cold=True), {}),
    "two_substeps": (dict(supersat_k=18), dict(mp_time=112.5)),
    "sedi_heat": (dict(supersat_k=10), dict(do_sedi_heat=True)),
    "cloud_fraction": (dict(supersat_k=18),
                       dict(do_qa=False, fast_sat_adj=False)),
    "const_fall_speeds": ({}, dict(
        const_vi=True, const_vs=True, const_vg=True, const_vr=True,
        vi_fac=1.0 / 3, vs_fac=1.0, vg_fac=2.0, vr_fac=4.0)),
    "prog_ccn_no_slopes": (dict(supersat_k=20), dict(
        prog_ccn=True, irain_f=1, z_slope_liq=False, z_slope_ice=False,
        de_ice=True, sedi_transport=False, do_sedi_w=False)),
}


def _both(inputs_kw, settings):
    arrays = microphysics_inputs(**inputs_kw)
    ref_state = ref_mp.MicrophysicsState(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    ref = ref_mp.Microphysics(RefConfig(**settings), jnp.asarray(AREA), DT)(
        ref_state)
    state = mp.MicrophysicsState.from_numpy(arrays, "cpu", torch.float64)
    got = mp.Microphysics(PhysicsConfig(**settings), torch.tensor(AREA), DT,
                          device="cpu")(state)
    return arrays, {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return (request.param,) + _both(*CASES[request.param])


def test_microphysics_matches_reference(case):
    name, arrays, ref, got = case
    assert set(got) == set(ref)
    bad = {}
    for key, r in ref.items():
        scale = float(np.abs(r).max())
        if key in PRECIPITATION:
            scale = max(float(np.abs(ref[k]).max()) for k in PRECIPITATION)
        elif key in ("udt", "vdt"):
            scale = float(np.abs(ref[key[0] + "1"]).max()) / DT
        err = float(np.abs(got[key] - r).max())
        if not err <= 1e-12 * max(scale, 1e-300):
            bad[key] = (err, scale)
    assert not bad, (name, bad)


def test_processes_fire(case):
    """The inputs take the branches: vapour, rain and temperature all
    change, cloud water too where there is any, and (but for the options
    that turn it off) the falling condensate moves momentum."""
    name, arrays, ref, got = case
    for key in ("qv_dt", "qr_dt", "pt_dt"):
        assert np.abs(got[key]).max() > 0, (name, key)
    if name == "cold_rain":
        assert np.abs(got["ql_dt"]).max() == 0
        assert (got["qs_dt"] + got["qg_dt"] + got["qi_dt"]).max() > 0
        assert got["qr_dt"].min() < 0
    else:
        assert np.abs(got["ql_dt"]).max() > 0
    if name == "cloud_fraction":
        assert got["qa_dt"].max() > 0
    if name != "prog_ccn_no_slopes":
        assert np.abs(got["udt"]).max() > 0


def test_total_water_conservation(case):
    """Column water change equals the precipitated mass (the invariant of
    the reference package's test_total_water_conservation)."""
    name, arrays, ref, got = case
    q_dt = sum(got[k] for k in ("qv_dt", "ql_dt", "qr_dt", "qi_dt", "qs_dt",
                                "qg_dt"))
    change = (arrays["delprsi"] * q_dt * DT).sum(-1)
    convt = 86400.0 / DT * con.RGRAV
    precip = (got["rain"] + got["snow"] + got["ice"] + got["graupel"]) / convt
    np.testing.assert_allclose(change, -precip, rtol=1e-9, atol=1e-10)


def _rand(rng, shape, lo, hi):
    return rng.uniform(lo, hi, shape)


def test_implicit_fall_matches_reference():
    rng = np.random.default_rng(0)
    shape = (5, 4, 30)
    q = _rand(rng, shape, 0.0, 1e-3)
    dp1 = _rand(rng, shape, 500.0, 1500.0)
    dzp = _rand(rng, shape, 100.0, 400.0)
    vt = _rand(rng, shape, 1e-3, 8.0)
    ref = ref_mp._implicit_fall(*(jnp.asarray(a) for a in (q, dp1, dzp, vt)),
                                112.5)
    got = mp._implicit_fall(*(torch.tensor(a) for a in (q, dp1, dzp, vt)),
                            112.5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                   atol=1e-13 * float(np.abs(r).max()))


def test_sedi_heat_matches_reference():
    rng = np.random.default_rng(1)
    shape = (5, 4, 30)
    tz = _rand(rng, shape, 220.0, 300.0)
    dp1 = _rand(rng, shape, 500.0, 1500.0)
    dz1 = -_rand(rng, shape, 100.0, 400.0)
    m1 = np.cumsum(_rand(rng, shape, 0.0, 1e-2), -1)
    qs = [_rand(rng, shape, 0.0, 1e-3) for _ in range(6)]
    args = (tz, dp1, dz1, m1, *qs)
    ref = ref_mp._sedi_heat(*(jnp.asarray(a) for a in args), con.C_LIQ)
    got = mp._sedi_heat(*(torch.tensor(a) for a in args), con.C_LIQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


@pytest.mark.parametrize("fn", ["wqs2", "iqs2"])
def test_saturation_functions_match_reference(fn):
    t = np.linspace(150.0, 400.0, 2001)
    den = np.full_like(t, 0.9)
    ref = getattr(ref_mp, fn)(jnp.asarray(t), jnp.asarray(den))
    got = getattr(mp, fn)(torch.tensor(t), torch.tensor(den))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)


def test_constants_are_python_floats_equal_to_reference():
    for settings in ({}, dict(mp_time=90.0, fast_sat_adj=False)):
        ref = ref_mp.setup_microphysics_constants(RefConfig(**settings), DT)
        got = mp.setup_microphysics_constants(PhysicsConfig(**settings), DT)
        assert got == ref
        assert all(isinstance(v, (float, int, tuple, list))
                   for v in got.values())


def test_config_fields_and_defaults_equal_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)
           if f.name != "emulator"}
    got = {f.name: f.default for f in dataclasses.fields(PhysicsConfig)
           if f.name != "emulator"}
    assert got == ref
    assert dataclasses.asdict(PhysicsConfig().emulator) == \
        dataclasses.asdict(RefConfig().emulator)


def test_state_lives_on_one_device_and_wrong_device_raises():
    arrays = microphysics_inputs()
    state = mp.MicrophysicsState.from_numpy(arrays, "cpu", torch.float32)
    assert state.pt.dtype == torch.float32 and state.qi_dt is None
    scheme = mp.Microphysics(PhysicsConfig(), torch.tensor(AREA), DT,
                             device="cpu")
    scheme.device = torch.device("meta")
    with pytest.raises(ValueError):
        scheme(state)
