"""Every example configuration hydrates in the port exactly as in the
reference package: `DriverConfig.from_yaml` of each file in
examples/configs/, as a nested dict, equals `pace_tpu`'s field by field.
A mesh that splits tiles along x or y (`c384_multihost_emulator.yaml`'s
[6, 4, 4]) hydrates and raises only when the `Driver` is built, naming its
ROADMAP item, 11b."""

import dataclasses
import glob
import os

import pytest
import torch

from pace_torch.testing import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "examples", "configs",
                                        "*.yaml")))
NAMES = [os.path.basename(p) for p in CONFIGS]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


def test_the_six_example_configs_are_there():
    assert NAMES == [
        "baroclinic_c12.yaml", "baroclinic_c12_coupled.yaml",
        "c384_multihost_emulator.yaml", "c48_sections_perf.yaml",
        "c96_baroclinic_shield.yaml", "tropical_cyclone_c48.yaml"]


@pytest.mark.parametrize("name", NAMES)
def test_example_config_hydrates_as_in_the_reference(name):
    from pace_torch.driver.driver import DriverConfig
    from pace_tpu.driver.driver import DriverConfig as RefConfig

    path = os.path.join(REPO, "examples", "configs", name)
    port = DriverConfig.from_yaml(path)
    ref = RefConfig.from_yaml(path)
    port_dict, ref_dict = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert port_dict.keys() == ref_dict.keys()
    for key in ref_dict:
        assert port_dict[key] == ref_dict[key], key
    assert port.n_timesteps() == ref.n_timesteps()
    assert type(port.initialization.config).__name__ == \
        type(ref.initialization.config).__name__


def test_multi_device_mesh_raises_at_the_driver_not_at_hydration():
    """The pod configuration's [6, 4, 4] mesh builds its 96 ranks of
    96 x 96-cell boxes; without a process group the Driver stops where
    every multi-rank run without torchrun or a coordinator does."""
    from pace_torch.driver.driver import Driver, DriverConfig
    from pace_torch.parallel.partition import Partition

    path = os.path.join(REPO, "examples", "configs",
                        "c384_multihost_emulator.yaml")
    config = DriverConfig.from_yaml(path)
    assert config.mesh.layout == (6, 4, 4)
    assert config.mesh.dcn_mesh_shape == (6, 1, 1)
    partition = Partition(config.mesh.layout, config.nx_tile,
                          dcn_mesh_shape=config.mesh.dcn_mesh_shape)
    assert partition.size == config.mesh.ranks == 96
    for rank in range(partition.size):
        si, sj = partition.domain(rank).compute()
        assert (si.stop - si.start, sj.stop - sj.start) == (96, 96)
    with pytest.raises(RuntimeError, match="torchrun"):
        Driver(config, device="cpu")


def test_fortran_restart_still_raises_naming_its_item():
    """The Fortran restart start, which raised naming ROADMAP item 10
    until it was ported, hydrates as in the reference package; a type
    neither package registers still raises."""
    from pace_torch.driver._from_dict import ConfigError
    from pace_torch.driver.initialization import InitializerSelector
    from pace_tpu.driver.initialization import (
        InitializerSelector as RefSelector,
    )

    port = InitializerSelector.from_dict({"type": "fortran_restart"})
    ref = RefSelector.from_dict({"type": "fortran_restart"})
    assert type(port.config).__name__ == type(ref.config).__name__
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    with pytest.raises(ConfigError, match="fortran_restart"):
        InitializerSelector.from_dict({"type": "fortran_restar"})


def test_restart_and_predefined_starts_hydrate(tmp_path):
    """The "restart" start reads what the driver writes; the "predefined"
    start moves a given state to the driver's device and dtype."""
    from pace_torch.driver.initialization import InitializerSelector
    from pace_torch.driver.restart import write_restart
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(12, 79)
    state = init_baroclinic_state(sizing, device="cpu", dtype=torch.float64)
    write_restart(state, None, str(tmp_path / "R"))
    restart = InitializerSelector.from_dict(
        {"type": "restart", "config": {"path": str(tmp_path / "R")}})
    predefined = InitializerSelector.from_dict(
        {"type": "predefined", "config": {"dycore_state": state}})
    for selector in (restart, predefined):
        got = selector.get_dycore_state(sizing, "cpu", torch.float32)
        for f in dataclasses.fields(state):
            want = getattr(state, f.name).to(torch.float32)
            assert torch.equal(getattr(got, f.name), want), f.name
