"""The port needs no JAX: with `jax` made unimportable, a fresh interpreter
imports every module of pace_torch (the physics, coupler and driver
packages and the driver's I/O among them), runs one coupled step through
the yaml entry point `python -m pace_torch.driver.run` with NetCDF
diagnostics and restart, on the CPU, and writes its state again through
fastpack; nothing of the reference package is imported on the
way (the ranks of tests/test_torch_sharded_step.py, and of its slow
torchrun run, check the same).  And the port's entry points
run on the card unless the caller asks for the CPU: read from their
signatures, and tried where there is no card; a rank under torchrun asks
for its own card."""

import inspect
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.set_num_threads(2)
import pace_torch
walked = [mod.name for mod in
          pkgutil.walk_packages(pace_torch.__path__, "pace_torch.")]
for name in walked:
    importlib.import_module(name)
for name in ("ops.saturation_adjustment", "ops.fv_subgridz",
             "models.physics.microphysics", "models.physics.physics",
             "models.physics.emulator", "models.physics.physics_state",
             "models.physics.config", "models.coupler.update_atmos_state",
             "models.coupler.fv_update_phys",
             "models.coupler.update_dwind_phys", "driver.driver",
             "driver.initialization", "driver.state", "driver._from_dict",
             "driver.run", "driver.diagnostics", "driver.restart",
             "driver.performance", "driver.safety_checks", "utils.timing",
             "utils.netcdf", "utils.zarrlite", "utils.host",
             "grid.stretch_transformation",
             "models.fv3.init.tropical_cyclone", "utils.checkpointer",
             "utils.debug", "utils.namelist", "utils.legacy_restart",
             "utils.quantity", "models.fv3.geos_wrapper",
             "validation.jw_day1", "validation.jw_baroclinic_wave",
             "utils.testing", "utils.functional_validation",
             "utils.nudging", "utils.monitor", "utils.translate",
             "utils.translate_cases", "utils.translate_cases_grid",
             "utils.translate_cases_physics", "driver.tools", "ops.bounds",
             "_native.fastpack", "parallel.partition", "parallel.comm",
             "parallel.halo", "parallel.traffic", "utils.pair_debug",
             "utils.gridtools"):
    assert "pace_torch." + name in walked, name
import os, tempfile, yaml
from pace_torch.driver.restart import load_restart_arrays
from pace_torch.driver.run import main
from pace_torch.utils.netcdf import NetCDFMonitor
tmp = tempfile.mkdtemp()
config = dict(
    nx_tile=12, nz=79, dt_atmos=225, seconds=225, dtype="float32",
    initialization={"type": "baroclinic"},
    dycore_config=dict(do_sat_adj=True, fv_sg_adj=3600, n_sponge=48),
    physics_config=dict(dt_atmos=225, mp_time=225),
    diagnostics_config=dict(path=os.path.join(tmp, "out"),
                            output_format="netcdf", names=["pt", "qvapor"]),
    restart_config=dict(save_restart=True, format="netcdf",
                        path=os.path.join(tmp, "RESTART")),
    performance_config=dict(experiment_name="no_jax"),
    safety_check_frequency=1)
with open(os.path.join(tmp, "config.yaml"), "w") as f:
    yaml.safe_dump(config, f)
os.chdir(tmp)
assert main([os.path.join(tmp, "config.yaml"), "--device", "cpu",
             "--log-level", "WARNING"]) == 0
coupled = load_restart_arrays(os.path.join(tmp, "RESTART"))
h = 3
for name in ("pt", "delp", "qvapor", "u", "v", "w"):
    assert np.isfinite(coupled[name][:, h:h + 12, h:h + 12]).all(), name
times, records = NetCDFMonitor.read(os.path.join(tmp, "out"))
assert len(records) == 1 and np.isfinite(records[0]["pt"]).all()
from pace_torch.driver.restart import write_restart
from pace_torch.models.fv3.state import DycoreState
state = DycoreState.from_numpy(coupled, "cpu", torch.float32)
write_restart(state, None, os.path.join(tmp, "npy"))  # through fastpack
back = load_restart_arrays(os.path.join(tmp, "npy"))
assert np.array_equal(back["pt"], state.pt.numpy(), equal_nan=True)
assert os.path.exists(os.path.join(tmp, "no_jax_perf.json"))
os.chdir("/")
import shutil
shutil.rmtree(tmp)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "pace_tpu")]
assert sys.modules["jax"] is None and loaded == ["jax"], loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted((REPO / "pace_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def _entry_points():
    from pace_torch.driver import Driver
    from pace_torch.models.coupler import (
        DycoreToPhysics,
        UpdateAtmosphereState,
    )
    from pace_torch.models.coupler.update_atmos_state import interior_mask
    from pace_torch.models.physics.emulator import MicrophysicsEmulator
    from pace_torch.models.physics.microphysics import Microphysics
    from pace_torch.models.physics.physics import Physics
    from pace_torch.models.physics.physics_state import PhysicsState
    from pace_torch.driver.performance import PerformanceConfig
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.models.fv3.init.tropical_cyclone import init_tc_state
    from pace_torch.utils.timing import Timer
    from pace_torch.models.fv3.geos_wrapper import GeosDycoreWrapper
    from pace_torch.validation import jw_baroclinic_wave, jw_day1
    from pace_torch.driver import tools
    from pace_torch.utils.translate_cases import BaseOpCase

    return [Driver, Driver.from_dict, Physics, Microphysics,
            MicrophysicsEmulator, DycoreToPhysics, UpdateAtmosphereState,
            interior_mask, PhysicsState.init_zeros, generate_grid_data,
            init_baroclinic_state, init_tc_state, PerformanceConfig.build,
            Timer, GeosDycoreWrapper, jw_day1.run_day1, jw_day1.setup,
            jw_baroclinic_wave.run, BaseOpCase, tools.build_driver,
            tools.memory_static_analysis, tools.kernel_theoretical_timing]


@pytest.mark.parametrize("index", range(22))
def test_new_entry_points_default_to_the_card(index):
    """The driver, the physics and the coupler are built on the card unless
    the caller asks for the CPU (read from the signature; needs no card)."""
    entry = _entry_points()[index]
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_the_yaml_entry_point_defaults_to_the_card():
    from pace_torch.driver import tools
    from pace_torch.driver.run import build_parser

    assert build_parser().parse_args(["config.yaml"]).device == "cuda"
    assert tools.build_parser().parse_args(
        ["memory", "config.yaml"]).device == "cuda"


def test_the_nine_day_run_defaults_to_the_card(monkeypatch):
    """python -m pace_torch.validation.jw_baroclinic_wave asks for the card
    unless told otherwise (read from its parser through a stand-in run)."""
    from pace_torch.validation import jw_baroclinic_wave

    asked = []

    def stand_in(days, device, dtype, out, state_out, ulp_noise):
        asked.append((days, device, dtype))
        raise RuntimeError("stop before the run")

    monkeypatch.setattr(jw_baroclinic_wave, "run", stand_in)
    with pytest.raises(RuntimeError, match="stop before"):
        jw_baroclinic_wave.main([])
    assert asked == [(9, "cuda", "float32")]


def test_a_rank_of_a_layout_runs_on_its_own_card(monkeypatch):
    """Under torchrun (RANK, LOCAL_RANK, WORLD_SIZE in the environment) a
    Driver of layout (2, 1, 1) asks for cuda:LOCAL_RANK by default, with
    NCCL where each rank has a card and gloo with host staging where the
    ranks share one, and refuses nothing before it reaches the card;
    `python -m pace_torch.driver.run` refuses a process count other than
    the layout's."""
    from pace_torch.driver import Driver
    from pace_torch.driver.run import main
    from pace_torch.parallel import comm as comm_mod

    for name, value in (("RANK", "1"), ("LOCAL_RANK", "1"),
                        ("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(name, value)
    asked = []

    def stand_in(device, *args):
        asked.append(torch.device(device))
        raise RuntimeError("stop at the process group")

    monkeypatch.setattr(comm_mod, "init_process_group", stand_in)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert comm_mod.backend_for("cuda:1") == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert comm_mod.rank_device("cuda") == torch.device("cuda:0")
    assert comm_mod.backend_for("cuda:0") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    config = dict(nx_tile=12, nz=79, dt_atmos=225,
                  initialization={"type": "baroclinic"},
                  mesh={"layout": [2, 1, 1]})
    with pytest.raises(RuntimeError, match="stop at the process group"):
        Driver.from_dict(config)
    assert asked == [torch.device("cuda:1")]
    with pytest.raises(ValueError, match="nproc_per_node 1"):
        main([str(REPO / "examples" / "configs" / "baroclinic_c12.yaml")])


def test_entry_points_raise_without_a_card():
    """Where there is no card, the defaults raise; nothing carries on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from pace_torch.driver import Driver
    from pace_torch.models.coupler import DycoreToPhysics
    from pace_torch.models.physics.config import PhysicsConfig
    from pace_torch.models.physics.emulator import (
        MicrophysicsEmulator,
        MLPEmulatorConfig,
    )
    from pace_torch.models.physics.microphysics import Microphysics
    from pace_torch.driver.run import main
    from pace_torch.models.fv3.init.tropical_cyclone import init_tc_state
    from pace_torch.models.physics.physics import Physics
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.models.fv3.geos_wrapper import GeosDycoreWrapper
    from pace_torch.validation.jw_day1 import run_day1
    from pace_torch.driver import tools
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.utils.translate_cases import CASES

    area = torch.full((2, 2), 1.0e10)
    config = dict(nx_tile=12, nz=79, dt_atmos=225,
                  initialization={"type": "baroclinic"})
    for build in (
            lambda: Driver.from_dict(config),
            lambda: Physics(PhysicsConfig(), area, 300.0, 225.0),
            lambda: Physics(PhysicsConfig(microphysics_scheme="emulator"),
                            area, 300.0, 225.0),
            lambda: Microphysics(PhysicsConfig(), area, 225.0),
            lambda: MicrophysicsEmulator(MLPEmulatorConfig(), 8),
            lambda: DycoreToPhysics(GridSizing(12, 79)),
            lambda: init_tc_state(GridSizing(12, 79)),
            lambda: GeosDycoreWrapper({"fv_core_nml": {"npx": 13}}),
            lambda: run_day1(steps=0),
            lambda: tools.memory_static_analysis(
                str(REPO / "examples" / "configs" / "baroclinic_c12.yaml")),
            lambda: CASES["XPPM"](
                GridSizing(12, 79),
                generate_grid_data(12, 79, device="cpu")).compute(
                    {"q": np.zeros((6, 24, 24, 79)), "iord": 8,
                     "c": np.zeros((6, 24, 24, 79))}),
            lambda: main([str(REPO / "examples" / "configs"
                              / "baroclinic_c12.yaml"),
                          "--log-level", "ERROR"])):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
