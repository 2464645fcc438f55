"""The port needs no JAX: with `jax` made unimportable, a fresh interpreter
imports every module of pace_torch, builds the C12 grid and initial state
and runs one dycore step on the CPU; nothing of the reference package is
imported on the way."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.set_num_threads(2)
import pace_torch
for mod in pkgutil.walk_packages(pace_torch.__path__, "pace_torch."):
    importlib.import_module(mod.name)
from pace_torch.grid.generation import generate_grid_data
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.models.fv3.dynamics import DynamicalCore
from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
from pace_torch.utils.gridtools import GridSizing
sizing = GridSizing(12, 79)
gd = generate_grid_data(12, 79, device="cpu", dtype=torch.float32)
core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False), sizing, gd, 225.0)
state = core.step_dynamics(init_baroclinic_state(
    sizing, device="cpu", dtype=torch.float32))
h = sizing.halo
assert bool(torch.isfinite(state.pt[:, h:h + 12, h:h + 12]).all())
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
