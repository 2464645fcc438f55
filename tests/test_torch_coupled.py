"""The slice as a whole: one C12/79 float64 coupled step (baroclinic init,
dt 225 s, do_sat_adj=True, fv_sg_adj=3600, n_sponge=48, GFDL microphysics
with mp_time=225: the settings of
examples/configs/baroclinic_c12_coupled.yaml) through the reference package
live and through `pace_torch.driver.Driver` on the CPU, every field of the
state within 1e-9 of its scale on the compute domain.

The reference side is composed as its `Driver._build_step` composes it
(dycore step -> dry convective adjustment -> DycoreToPhysics -> Physics ->
UpdateAtmosphereState) in two jitted stages, so the state between them also
checks the dycore step with `do_sat_adj=True` alone.

The baroclinic wave starts below saturation everywhere, so in its first
step the saturation adjustment and the microphysics find nothing to
condense.  The same step is therefore run a second time from the initial
state with its vapour multiplied by 1.5, which saturates the lower
troposphere: cloud water and ice form in the remap's adjustment, and the
microphysics rains, heats and moves momentum.  That second step of both
packages is marked `slow` (the reference's compiled C12 step alone takes
most of a minute on a busy CPU); the column-sized module tests take the
same branches in every run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import generate_grid_data as ref_grid
from pace_tpu.models.coupler import DycoreToPhysics as RefD2P
from pace_tpu.models.coupler import UpdateAtmosphereState as RefUpdate
from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefDynConfig
from pace_tpu.models.fv3.dynamics import DynamicalCore as RefCore
from pace_tpu.models.fv3.init.baroclinic import (
    init_baroclinic_state as ref_init,
)
from pace_tpu.models.physics.config import PhysicsConfig as RefPhysConfig
from pace_tpu.models.physics.physics import Physics as RefPhysics
from pace_tpu.ops.fv_subgridz import (
    dry_convective_adjustment as ref_dry_convective_adjustment,
)
from pace_tpu.utils.gridtools import GridSizing as RefSizing
from pace_torch.driver import Driver
from pace_torch.models.fv3.state import DycoreState
from pace_torch.testing import torch_threads

N_, NZ, H, DT = 12, 79, 3, 225.0
DYCORE = dict(do_sat_adj=True, fv_sg_adj=3600, n_sponge=48)
PHYSICS = dict(dt_atmos=225, mp_time=225)
MOISTENED = 1.5
CONFIG = dict(
    nx_tile=N_, nz=NZ, dt_atmos=225, seconds=450, dtype="float64",
    initialization={"type": "baroclinic"}, dycore_config=DYCORE,
    physics_config=PHYSICS,
)


@pytest.fixture(scope="module")
def reference():
    """The reference package's initial state and its coupled step as two
    jitted stages (traced and compiled once for both starts)."""
    sizing = RefSizing(N_, NZ)
    gd = ref_grid(N_, NZ, dtype=jnp.float64)
    cfg = RefDynConfig(**DYCORE)
    core = RefCore(cfg, sizing, gd, timestep=DT)
    ptop = float(np.asarray(gd.vertical.ptop))
    physics = RefPhysics(RefPhysConfig(**PHYSICS), gd.horizontal.area, ptop,
                         DT)
    d2p = RefD2P(sizing, dtype=jnp.float64)
    update = RefUpdate(gd, core.topo, sizing, DT, c2l_order=cfg.c2l_ord)

    def physics_step(state):
        s = {f.name: getattr(state, f.name)
             for f in dataclasses.fields(state)}
        s, u_dt0, v_dt0 = ref_dry_convective_adjustment(
            s, DT, cfg.fv_sg_adj, cfg.n_sponge, nwat=cfg.nwat, ptop=ptop)
        state = type(state)(**s)
        return update(state, physics(d2p(state)), u_dt0=u_dt0, v_dt0=v_dt0)

    return (ref_init(sizing, dtype=jnp.float64), jax.jit(core.step_dynamics),
            jax.jit(physics_step))


def _reference_halves(reference, factor):
    state0, dycore_step, physics_step = reference
    after_dycore = dycore_step(
        dataclasses.replace(state0, qvapor=state0.qvapor * factor))
    return after_dycore, physics_step(after_dycore)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def baroclinic(reference):
    """From the plain start: (reference, port) states after the dycore half
    and after the step, and the driver.  The port's pair is one
    `Driver.step()`, with the state its dycore half handed on kept."""
    driver = Driver.from_dict(CONFIG, device="cpu")
    handed_on = []
    step_dynamics = driver.dycore.step_dynamics

    def keep(state):
        handed_on.append(step_dynamics(state))
        return handed_on[-1]

    driver.dycore.step_dynamics = keep
    driver.step()
    del driver.dycore.step_dynamics
    (after_dycore,) = handed_on
    return (_reference_halves(reference, 1.0),
            (after_dycore, driver.state.dycore_state), driver)


@pytest.fixture(scope="module")
def moistened(reference):
    """As `baroclinic`, from the start with its vapour multiplied; the
    port's pair is the two halves called one after the other."""
    driver = Driver.from_dict(CONFIG, device="cpu")
    state0 = driver.state.dycore_state
    after_dycore = driver.dycore.step_dynamics(
        dataclasses.replace(state0, qvapor=state0.qvapor * MOISTENED))
    return (_reference_halves(reference, MOISTENED),
            (after_dycore, driver.physics_step(after_dycore)), driver)


# the moistened start costs a second step of both packages
STARTS = pytest.mark.parametrize(
    "start", ["baroclinic",
              pytest.param("moistened", marks=pytest.mark.slow)])


def _domain(a):
    return a[:, H:H + N_, H:H + N_]


def _bad_fields(got, ref, tol=1e-9):
    bad = {}
    for f in dataclasses.fields(ref):
        r = _domain(np.asarray(getattr(ref, f.name)))
        g = _domain(getattr(got, f.name).numpy())
        err = float(np.abs(r - g).max()) / (float(np.abs(r).max()) + 1e-30)
        if not err <= tol:
            bad[f.name] = err
    return bad


def test_initial_state_is_the_reference_s(reference):
    ref0 = reference[0]
    fresh = Driver.from_dict(CONFIG, device="cpu").state.dycore_state
    assert isinstance(fresh, DycoreState)
    for f in dataclasses.fields(ref0):
        np.testing.assert_array_equal(
            _domain(getattr(fresh, f.name).numpy()),
            _domain(np.asarray(getattr(ref0, f.name))), err_msg=f.name)


@STARTS
def test_dycore_step_with_sat_adj_matches_reference(request, start):
    ref, got, _ = request.getfixturevalue(start)
    bad = _bad_fields(got[0], ref[0])
    assert not bad, bad


@STARTS
def test_coupled_step_matches_reference(request, start):
    ref, got, _ = request.getfixturevalue(start)
    bad = _bad_fields(got[1], ref[1])
    assert not bad, bad


def test_driver_step_is_the_two_halves(baroclinic):
    _, (after_dycore, stepped), driver = baroclinic
    composed = driver.physics_step(after_dycore)
    for f in dataclasses.fields(composed):
        assert torch.allclose(getattr(stepped, f.name),
                              getattr(composed, f.name), rtol=0, atol=0,
                              equal_nan=True), f.name
    assert (driver.time - driver.config.initialization.start_time
            ).total_seconds() == DT


@pytest.mark.slow
def test_moistened_start_makes_every_half_act(baroclinic, moistened):
    """From the moistened start the remap's saturation adjustment forms
    cloud water and ice, and the physics half rains and changes
    temperature, mass and winds (or the comparison would be of copies)."""
    (dry_dyn, _), (wet_dyn, wet_step) = baroclinic[0], moistened[0]
    assert float(_domain(np.asarray(dry_dyn.qliquid)).max()) == 0.0
    assert float(_domain(np.asarray(wet_dyn.qliquid)).max()) > 1e-4
    assert float(_domain(np.asarray(wet_dyn.qice)).max()) > 1e-7
    for name, least in (("pt", 1e-3), ("qvapor", 1e-7), ("qrain", 1e-5),
                        ("delp", 1e-3), ("u", 1e-5), ("v", 1e-5)):
        a = _domain(np.asarray(getattr(wet_dyn, name)))
        b = _domain(np.asarray(getattr(wet_step, name)))
        assert np.abs(a - b).max() > least, name


@STARTS
def test_coupled_state_is_physical(request, start):
    _, got, _ = request.getfixturevalue(start)
    state = got[1]
    for f in dataclasses.fields(state):
        assert bool(torch.isfinite(_domain(getattr(state, f.name))).all()), \
            f.name
    pt, delp = _domain(state.pt), _domain(state.delp)
    assert 150.0 < float(pt.min()) <= float(pt.max()) < 350.0
    assert float(delp.min()) > 0.0
    assert float(_domain(state.qvapor).min()) >= 0.0


# --- the driver's configuration ---------------------------------------------

def test_driver_config_defaults_equal_reference():
    from pace_tpu.driver.driver import DriverConfig as RefDriverConfig
    from pace_torch.driver import DriverConfig

    ref = {f.name: f.default for f in dataclasses.fields(RefDriverConfig)}
    for f in dataclasses.fields(DriverConfig):
        assert f.name in ref, f.name
        assert f.default == ref[f.name] or f.default_factory is not \
            dataclasses.MISSING, f.name
    config = DriverConfig.from_dict(CONFIG)
    assert config.n_timesteps() == 2
    assert config.dycore_config.fv_sg_adj == 3600
    assert config.dycore_config.do_dry_convective_adjustment
    assert config.physics_config.mp_time == 225.0
    assert config.initialization.type == "baroclinic"


@pytest.mark.parametrize("patch, refused", [
    ({"nx_tiles": 12}, True),
    ({"dycore_config": {"do_sat_adj": True, "n_spunge": 3}}, False),
    ({"physics_config": {"mp_tim": 225}}, True),
    ({"physics_config": {"emulator": {"hidden": [8]}}}, True),
    ({"initialization": {"type": "baroclinic", "config": {"start": "x"}}},
     True),
    ({"initialization": {"type": "aquaplanet"}}, True),
    ({"initialization": {"type": "baroclinic", "kind": 1}}, False),
    ({"nz": "79"}, True),
    ({"grid_config": {"strech_factor": 2.5}}, True),
    ({"mesh": {"layuot": [1, 1, 1]}}, True),
], ids=["top", "dycore", "physics", "emulator", "init_config", "init_type",
        "init_key", "wrong_type", "grid_key", "mesh_key"])
def test_from_dict_refuses_an_unknown_key(patch, refused, caplog):
    """An unknown key is refused where the reference package refuses it;
    in `dycore_config` and beside `type` in `initialization` the reference
    drops it, and so does the port, with a warning that names it."""
    from pace_torch.driver import DriverConfig
    from pace_tpu.driver.driver import DriverConfig as RefDriverConfig

    if refused:
        with pytest.raises(ValueError):
            DriverConfig.from_dict({**CONFIG, **patch})
        return
    with caplog.at_level("WARNING"):
        config = DriverConfig.from_dict({**CONFIG, **patch})
    assert dataclasses.asdict(config) == dataclasses.asdict(
        RefDriverConfig.from_dict({**CONFIG, **patch}))
    key = "n_spunge" if "dycore_config" in patch else "kind"
    assert any(key in r.getMessage() for r in caplog.records)


def test_from_dict_requires_its_keys():
    from pace_torch.driver import DriverConfig

    with pytest.raises(ValueError):
        DriverConfig.from_dict({k: v for k, v in CONFIG.items()
                                if k != "nx_tile"})


@pytest.mark.parametrize("patch", [
    {"diagnostics_config": {"path": "output"}},
    {"restart_config": {"save_restart": True}},
    {"performance_config": {"performance_mode": True}},
    {"safety_check_frequency": 4},
    {"mesh": {"layout": [6, 1, 1]}},
    {"mesh": {"layout": [1, 1, 1], "multihost": True}},
    {"grid_config": {"stretch_factor": 2.5}},
    {"grid_config": {"eta_file": "eta79.nc"}},
    {"grid_config": {"lon_target": 10.0}},
    {"initialization": {"type": "tropicalcyclone"}},
    {"initialization": {"type": "restart", "config": {"path": "RESTART"}}},
    {"initialization": {"type": "fortran_restart"}},
], ids=["diagnostics", "restart", "performance", "safety", "mesh",
        "multihost", "stretch", "eta_file", "lon_target", "tropicalcyclone",
        "restart_init", "fortran_restart"])
def test_from_dict_refuses_an_unported_section(patch):
    """Every section here, refused before it was ported (the Fortran
    restart start until item 10 ported it, a mesh of more than one device
    until item 11 did), hydrates as in the reference package.  A mesh of
    more than one rank runs under torchrun (or with a coordinator): the
    Driver built in a lone process says so."""
    from pace_torch.driver import DriverConfig
    from pace_tpu.driver.driver import DriverConfig as RefDriverConfig

    kwargs = {**CONFIG, **patch}
    config = DriverConfig.from_dict(kwargs)
    assert dataclasses.asdict(config) == dataclasses.asdict(
        RefDriverConfig.from_dict(kwargs))
    if "mesh" in patch:
        with pytest.raises(RuntimeError, match="torchrun"):
            Driver(config, device="cpu")


def test_one_device_sections_are_accepted():
    from pace_torch.driver import DriverConfig

    config = DriverConfig.from_dict({
        **CONFIG, "mesh": {"layout": [1, 1, 1]},
        "grid_config": {"stretch_factor": None, "lon_target": 350.0},
        "safety_check_frequency": None,
        "physics_config": {"microphysics_scheme": "emulator",
                           "emulator": {"hidden_sizes": [256, 256, 256]}}})
    assert config.physics_config.emulator.hidden_sizes == (256, 256, 256)


def test_dycore_only_driver_has_no_physics():
    driver = Driver.from_dict({**CONFIG, "dycore_only": True,
                               "dycore_config": {"do_sat_adj": False}},
                              device="cpu")
    assert driver.physics is None and driver.physics_step is None
    with pytest.raises(ValueError):
        Driver.from_dict({**CONFIG, "dtype": "float16"}, device="cpu")
