"""The port's physics driver against the reference package's on the same
numpy inputs (float64, CPU): the GFS state-in conversion, the pressure and
geopotential diagnostics, `prepare_microphysics`, and `Physics.__call__`
with the GFDL scheme and with the emulator (the reference package's drawn
weights, with an output layer made non-zero, loaded into the port), every
field of the returned PhysicsState within 1e-12 of its scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.physics import physics as ref_physics
from pace_tpu.models.physics.config import PhysicsConfig as RefConfig
from pace_tpu.models.physics.emulator import (
    MLPEmulatorConfig as RefEmulatorConfig,
)
from pace_tpu.models.physics.physics_state import (
    PhysicsState as RefPhysicsState,
)
from pace_torch.models.physics import physics
from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.models.physics.emulator import MLPEmulatorConfig
from pace_torch.models.physics.physics_state import PhysicsState
from pace_torch.testing import microphysics_inputs, torch_threads

SHAPE = (4, 3, 24)
DT = 225.0
PTOP = 300.0
AREA = np.full(SHAPE[:2], 1.0e10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def physics_state_arrays(seed=3):
    """Every field of a PhysicsState as numpy: the sounding of
    `microphysics_inputs` with ozone, TKE, w and omega added."""
    rng = np.random.default_rng(seed + 100)
    col = microphysics_inputs(SHAPE, seed=seed, supersat_k=18)
    ref0 = RefPhysicsState.init_zeros(SHAPE, dtype=jnp.float64)
    arrays = {f.name: np.asarray(getattr(ref0, f.name))
              for f in dataclasses.fields(ref0)}
    for name in ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel",
                 "qcld", "pt", "delp", "delz", "ua", "va", "land"):
        arrays[name] = col[name]
    arrays["qo3mr"] = 1.0e-6 * rng.uniform(0.5, 1.5, SHAPE)
    arrays["qsgs_tke"] = rng.uniform(0.0, 1.0, SHAPE)
    arrays["w"] = 0.1 * rng.standard_normal(SHAPE)
    arrays["omga"] = rng.standard_normal(SHAPE)
    return arrays


def _ref_state(arrays):
    return RefPhysicsState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _assert_states_close(got, ref, tol=1e-12):
    bad = {}
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))
        g = getattr(got, f.name).numpy()
        assert g.shape == r.shape, f.name
        err = float(np.abs(g - r).max())
        if not err <= tol * max(float(np.abs(r).max()), 1e-300):
            bad[f.name] = err
    assert not bad, bad


def test_physics_state_layout_equals_reference():
    ref = RefPhysicsState.init_zeros(SHAPE, dtype=jnp.float64)
    got = PhysicsState.init_zeros(SHAPE, device="cpu", dtype=torch.float64)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert tuple(getattr(got, f.name).shape) == getattr(ref, f.name).shape
        assert getattr(got, f.name).dtype == torch.float64
    arrays = physics_state_arrays()
    state = PhysicsState.from_numpy(arrays, "cpu", torch.float32)
    assert state.pt.dtype == torch.float32
    np.testing.assert_array_equal(state.land.numpy(),
                                  arrays["land"].astype(np.float32))


def test_statein_matches_reference():
    arrays = physics_state_arrays()
    pktop, pk0inv = (PTOP / 1.0e5) ** 0.2857, (1.0 / 1.0e5) ** 0.2857
    ref = ref_physics.atmos_phys_driver_statein(
        _ref_state(arrays), PTOP, pktop, pk0inv)
    got = physics.atmos_phys_driver_statein(
        PhysicsState.from_numpy(arrays, "cpu", torch.float64), PTOP, pktop,
        pk0inv)
    _assert_states_close(got, ref)
    assert float(np.abs(np.asarray(ref.delp) - arrays["delp"]).max()) > 0


def test_prs_phi_and_prepare_match_reference():
    rng = np.random.default_rng(0)
    nz = SHAPE[-1]
    dphi = rng.uniform(500.0, 3000.0, SHAPE)
    phii = np.concatenate(
        [np.cumsum(dphi[..., ::-1], -1)[..., ::-1],
         np.zeros(SHAPE[:2] + (1,))], -1)
    prsi = np.concatenate(
        [np.full(SHAPE[:2] + (1,), PTOP),
         PTOP + np.cumsum(rng.uniform(500.0, 1500.0, SHAPE), -1)], -1)
    t = rng.uniform(200.0, 300.0, SHAPE)
    q = rng.uniform(-1e-4, 2e-2, SHAPE)
    omga = rng.standard_normal(SHAPE)
    prsl = 0.5 * (prsi[..., 1:] + prsi[..., :-1])
    j = jnp.asarray
    tt = torch.tensor

    ref = ref_physics.get_prs_fv3(j(phii), j(prsi), j(t), j(q))
    got = physics.get_prs_fv3(tt(phii), tt(prsi), tt(t), tt(q))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)
    del_gz = np.asarray(ref[1])
    ref = ref_physics.get_phi_fv3(j(t), j(q), j(del_gz))
    got = physics.get_phi_fv3(tt(t), tt(q), tt(del_gz))
    for g, r in zip(got, ref):
        assert g.shape[-1] in (nz, nz + 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)
    ref = ref_physics.prepare_microphysics(j(phii), j(omga), j(q), j(t),
                                           j(prsl))
    got = physics.prepare_microphysics(tt(phii), tt(omga), tt(q), tt(t),
                                       tt(prsl))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)


def test_physics_gfdl_matches_reference():
    arrays = physics_state_arrays()
    ref = ref_physics.Physics(RefConfig(), jnp.asarray(AREA), PTOP, DT)(
        _ref_state(arrays))
    got = physics.Physics(PhysicsConfig(), torch.tensor(AREA), PTOP, DT,
                          device="cpu")(
        PhysicsState.from_numpy(arrays, "cpu", torch.float64))
    _assert_states_close(got, ref)
    moved = np.abs(np.asarray(ref.physics_updated_pt) - np.asarray(ref.pt))
    assert float(moved.max()) > 1e-3


def test_physics_emulator_matches_reference():
    """The emulator scheme behind Physics, computing in float64 so that the
    comparison is of the driver's arithmetic and not of matmul rounding
    (tests/test_torch_emulator.py holds float32 and bfloat16)."""
    arrays = physics_state_arrays()
    kw = dict(hidden_sizes=(32, 16), compute_dtype="float64")
    ref_p = ref_physics.Physics(
        RefConfig(microphysics_scheme="emulator",
                  emulator=RefEmulatorConfig(**kw)),
        jnp.asarray(AREA), PTOP, DT)
    port_p = physics.Physics(
        PhysicsConfig(microphysics_scheme="emulator",
                      emulator=MLPEmulatorConfig(**kw)),
        torch.tensor(AREA), PTOP, DT, device="cpu")
    # first calls build the emulators (an exact no-op before training)
    ref0 = ref_p(_ref_state(arrays))
    got0 = port_p(PhysicsState.from_numpy(arrays, "cpu", torch.float64))
    np.testing.assert_array_equal(np.asarray(ref0.physics_updated_pt),
                                  np.asarray(ref0.pt))
    assert torch.equal(got0.physics_updated_pt, got0.pt)
    # the reference's drawn weights with a non-zero output layer, in both
    rng = np.random.default_rng(2)
    params = {k: np.asarray(v) for k, v in ref_p._microphysics.params.items()}
    params["w2"] = (0.05 * rng.standard_normal(params["w2"].shape)
                    ).astype(np.float32)
    ref_p._microphysics.params = {k: jnp.asarray(v)
                                  for k, v in params.items()}
    port_p._microphysics.load_numpy_params(params)
    ref = ref_p(_ref_state(arrays))
    got = port_p(PhysicsState.from_numpy(arrays, "cpu", torch.float64))
    _assert_states_close(got, ref)
    assert float(np.abs(np.asarray(ref.physics_updated_pt)
                        - np.asarray(ref.pt)).max()) > 0


def test_unknown_scheme_and_wrong_device_raise():
    with pytest.raises(ValueError):
        physics.Physics(PhysicsConfig(microphysics_scheme="none"),
                        torch.tensor(AREA), PTOP, DT, device="cpu")
    scheme = physics.Physics(PhysicsConfig(), torch.tensor(AREA), PTOP, DT,
                             device="cpu")
    scheme.device = torch.device("meta")
    with pytest.raises(ValueError):
        scheme(PhysicsState.from_numpy(physics_state_arrays(), "cpu",
                                       torch.float64))
