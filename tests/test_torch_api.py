"""The port's package API and its yaml hydration:

- `from pace_torch import <name>` for the eleven names `pace_tpu` exports,
  imported lazily, so that `import pace_torch` loads none of the modules;
- a yaml file with a key the port does not know in `dycore_config`, or a
  key beside `type` and `config` in `initialization`, hydrates as the
  reference package hydrates it, with a warning that names the key."""

import dataclasses
import importlib
import os
import subprocess
import sys

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = ("DynamicalCore", "DynamicalCoreConfig", "DycoreState", "Physics",
         "PhysicsConfig", "PhysicsState", "Driver", "DriverConfig",
         "GridSizing", "generate_grid_data", "Quantity")


@pytest.mark.parametrize("name", NAMES)
def test_package_exports_the_reference_names(name):
    import pace_torch
    import pace_tpu

    exported = getattr(pace_torch, name)
    assert exported is getattr(
        importlib.import_module(pace_torch._EXPORTS[name]), name)
    assert exported.__name__ == getattr(pace_tpu, name).__name__


def test_import_is_light_and_unknown_names_raise():
    script = ("import sys, pace_torch\n"
              "heavy = [m for m in sys.modules if m.startswith('pace_torch.')]\n"
              "assert not heavy, heavy\n"
              "from pace_torch import Quantity\n"
              "try:\n"
              "    pace_torch.Nothing\n"
              "except AttributeError:\n"
              "    print('LIGHT_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert "LIGHT_OK" in proc.stdout, proc.stderr[-2000:]


def test_quantity_checks_its_metadata():
    import torch

    from pace_torch import Quantity

    data = torch.arange(2 * 8 * 8, dtype=torch.float64).reshape(2, 8, 8)
    q = Quantity(data, ("tile", "x", "y"), "K", (0, 3, 3), (2, 2, 2))
    assert q.view.shape == (2, 2, 2) and q.shape == data.shape
    assert torch.equal(q.view, data[:, 3:5, 3:5])
    r = q.with_view(torch.zeros(2, 2, 2))
    assert float(r.view.abs().max()) == 0.0 and torch.equal(q.data, data)
    t = q.transpose(("y", "x", "tile"))
    assert t.dims == ("y", "x", "tile") and t.origin == (3, 3, 0)
    with pytest.raises(ValueError):
        Quantity(data, ("tile", "x"), "K", (0, 3, 3), (2, 2, 2))


@pytest.mark.parametrize("section, extra", [
    ("dycore_config", {"made_up_key": 3}),
    ("initialization", {"comment": "started from the JW wave"}),
], ids=["dycore_config", "initialization"])
def test_extra_key_hydrates_as_in_the_reference(section, extra, tmp_path,
                                                caplog):
    from pace_torch.driver.driver import DriverConfig
    from pace_tpu.driver.driver import DriverConfig as RefConfig

    with open(os.path.join(REPO, "examples", "configs",
                           "baroclinic_c12.yaml")) as f:
        config = yaml.safe_load(f)
    config[section].update(extra)
    path = str(tmp_path / "baroclinic_c12.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)

    with caplog.at_level("WARNING"):
        port = DriverConfig.from_yaml(path)
    ref = RefConfig.from_yaml(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    key = next(iter(extra))
    warned = [r.getMessage() for r in caplog.records
              if r.levelname == "WARNING"]
    assert any(key in message and section in message
               for message in warned), warned
