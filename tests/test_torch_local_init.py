"""A rank builds only its own block of the initial state
(`Partition.part(rank)`, parallel/partition.py `RankPart`): for every rank
of (1, 2, 2), (2, 2, 2), (1, 2, 4) and (6, 2, 2) at C12/79 float64, every
leaf of the rank's own build equals the whole cube's build cut to the rank
(`Partition.scatter`), bit for bit, NaN for NaN, halo included, for each
start: the baroclinic wave, the tropical cyclone, restarts from a .npy
directory, from NetCDF and from .npz, and the Fortran restart.  One case
ties a rank's baroclinic block to the reference package's whole-cube
build; two build a rank's `Driver` (baroclinic and tropical-cyclone
starts) with the whole-cube state builder and the whole cube's metric
terms made to raise.  Everything runs in this process."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from pace_torch.driver.initialization import InitializerSelector
from pace_torch.models.fv3.state import FIELD_METADATA, zeros_numpy
from pace_torch.parallel.partition import Partition, RankPart
from pace_torch.testing import torch_threads
from pace_torch.utils.gridtools import GridSizing
from pace_torch.utils.netcdf import write_dataset

N_, NZ = 12, 79
SIZING = GridSizing(N_, NZ)
LAYOUTS = [(1, 2, 2), (2, 2, 2), (1, 2, 4), (6, 2, 2)]
STARTS = ["baroclinic", "tropicalcyclone", "restart_npy", "restart_netcdf",
          "restart_npz", "fortran_restart"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def restart_dirs(tmp_path_factory):
    """The directory of each restart start, written from one seeded
    float32 state (a float32 run's restart; random values at every
    storage point, halo included)."""
    rng = np.random.default_rng(10)
    arrays = {name: rng.standard_normal(a.shape, dtype=np.float32)
              for name, a in zeros_numpy(SIZING).items()}
    root = tmp_path_factory.mktemp("local_init")
    dirs = {k: root / k for k in STARTS[2:]}
    os.makedirs(dirs["restart_npy"] / "dycore_state")
    for name, a in arrays.items():
        np.save(dirs["restart_npy"] / "dycore_state" / f"{name}.npy", a)
    os.makedirs(dirs["restart_netcdf"])
    write_dataset(str(dirs["restart_netcdf"] / "dycore_state.nc"), arrays)
    os.makedirs(dirs["restart_npz"])
    np.savez(dirs["restart_npz"] / "dycore_state.npz", **arrays)
    os.makedirs(dirs["fortran_restart"])
    chip_smoke.write_fortran_restart(str(dirs["fortran_restart"]), arrays,
                                     N_)
    return dirs


def _selector(start, dirs):
    if start in ("baroclinic", "tropicalcyclone"):
        return InitializerSelector.from_dict({"type": start})
    kind = "fortran_restart" if start == "fortran_restart" else "restart"
    return InitializerSelector.from_dict(
        {"type": kind, "config": {"path": str(dirs[start])}})


def _leaves(state) -> dict:
    return {f.name: getattr(state, f.name).numpy()
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def whole(restart_dirs):
    """The whole cube's initial state of each start, built once."""
    return {start: _leaves(_selector(start, restart_dirs).get_dycore_state(
        SIZING, "cpu", torch.float64)) for start in STARTS}


def _assert_cut(partition, rank, got: dict, cube: dict):
    assert got.keys() == cube.keys() == FIELD_METADATA.keys()
    for name, value in got.items():
        want = partition.scatter(cube[name], rank)
        assert value.dtype == want.dtype, name
        assert np.array_equal(value, want, equal_nan=True), (rank, name)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("start", STARTS)
def test_every_rank_builds_the_cut_of_the_whole_cube(start, layout, whole,
                                                     restart_dirs):
    partition = Partition(layout, N_)
    init = _selector(start, restart_dirs)
    for rank in range(partition.size):
        part = partition.part(rank)
        state = init.get_dycore_state(SIZING, "cpu", torch.float64, part)
        assert tuple(state.u.shape[:3]) == part.shape
        _assert_cut(partition, rank, _leaves(state), whole[start])


def test_a_ranks_baroclinic_block_is_the_cut_of_the_reference():
    """Rank 1 of (1, 2, 2): its float64 block against the cut of the
    reference package's whole-cube baroclinic build."""
    from pace_torch.grid import eta
    from pace_torch.grid.generation import _generate_metric_terms
    from pace_torch.models.fv3.init.baroclinic import (
        init_baroclinic_state_numpy,
    )
    from pace_tpu.grid import eta as ref_eta
    from pace_tpu.grid.generation import (
        _generate_metric_terms as ref_metric_terms,
    )
    from pace_tpu.models.fv3.init import baroclinic as ref_baroclinic
    from pace_tpu.utils.gridtools import GridSizing as RefSizing

    partition, rank = Partition((1, 2, 2), N_), 1
    got = init_baroclinic_state_numpy(
        _generate_metric_terms(N_, 3), eta.set_hybrid_pressure_coefficients(
            NZ), SIZING, part=partition.part(rank))
    ref = ref_baroclinic.init_baroclinic_state_numpy(
        ref_metric_terms(N_, 3), ref_eta.set_hybrid_pressure_coefficients(
            NZ), RefSizing(N_, NZ))
    _assert_cut(partition, rank, got,
                {k: np.asarray(v) for k, v in ref.items()})


def _driver_rank(monkeypatch, start):
    """A (1, 2, 2) rank's Driver in this process (its process group
    stubbed: no exchange happens while it is built) from `start`, with the
    whole-cube state builder and the whole cube's metric terms made to
    raise.  Returns (partition, rank, driver)."""
    from pace_torch.driver import Driver
    from pace_torch.driver.driver import MeshConfig
    from pace_torch.grid import generation

    partition, rank = Partition((1, 2, 2), N_), 2

    @dataclasses.dataclass
    class Group:
        rank: int
        size: int

    def whole_cube(*args, **kwargs):
        raise AssertionError("a rank built the whole cube's state or terms")

    monkeypatch.setattr(MeshConfig, "build",
                        lambda self, n, h, device: (partition,
                                                    Group(rank, 4)))
    monkeypatch.setattr(RankPart, "whole", whole_cube)
    monkeypatch.setattr(generation, "_metric_terms", whole_cube)
    driver = Driver.from_dict(dict(
        nx_tile=N_, nz=NZ, dt_atmos=225, minutes=1, dycore_only=True,
        dtype="float64", initialization={"type": start},
        mesh={"layout": [1, 2, 2]}), device="cpu")
    assert driver.rank == rank
    return partition, rank, driver


def _assert_grid_cut(partition, rank, grid):
    from pace_torch.grid.generation import generate_grid_data

    want = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float64
                              ).scattered(partition.part(rank).cut)
    for bundle in ("horizontal", "angle", "damping", "vertical"):
        for f in dataclasses.fields(getattr(want, bundle)):
            a = getattr(getattr(grid, bundle), f.name)
            b = getattr(getattr(want, bundle), f.name)
            assert (torch.equal(a, b) if isinstance(b, torch.Tensor)
                    else a == b), (bundle, f.name)


def test_a_driver_rank_never_builds_the_whole_cube_state(monkeypatch, whole):
    """A (1, 2, 2) rank's baroclinic Driver, the whole-cube state builder
    and the whole cube's metric terms made to raise: its state is its
    block of the whole cube's, and its grid the whole cube's grid cut to
    it."""
    partition, rank, driver = _driver_rank(monkeypatch, "baroclinic")
    monkeypatch.undo()
    _assert_cut(partition, rank, _leaves(driver.state.dycore_state),
                whole["baroclinic"])
    _assert_grid_cut(partition, rank, driver.state.grid_data)


def test_a_driver_rank_never_builds_the_whole_cube_tc_state(monkeypatch,
                                                            whole):
    """The same for the tropical-cyclone start."""
    partition, rank, driver = _driver_rank(monkeypatch, "tropicalcyclone")
    monkeypatch.undo()
    _assert_cut(partition, rank, _leaves(driver.state.dycore_state),
                whole["tropicalcyclone"])
    _assert_grid_cut(partition, rank, driver.state.grid_data)


def test_a_ranks_report_lists_each_ranks_start_and_host_peak(tmp_path):
    """The perf JSON of several ranks lists each rank's initialization
    seconds and host and card memory peaks (rank order), beside the
    timers' maximum over the ranks."""
    import json

    from pace_torch.driver.performance import (
        PerformanceCollector,
        host_peak_bytes,
    )

    collector = PerformanceCollector("ranks", device="cpu")
    with collector.total_timer.clock("initialization"):
        pass
    mine = collector.times()
    start = mine["total_times"]["initialization"]
    assert 0 < mine["host_peak_bytes"] <= host_peak_bytes()
    assert mine["device_peak_bytes"] is None
    other = dict(mine, total_times={"initialization": start + 2.5},
                 host_peak_bytes=7, device_peak_bytes=9)
    collector.take_max([mine, other])
    collector.write_out_performance("torch/cpu", 225.0, str(tmp_path))
    report = json.loads((tmp_path / "ranks_perf.json").read_text())
    assert report["total_times"] == {"initialization": start + 2.5}
    assert report["ranks"] == [
        dict(rank=0, initialization=start,
             host_peak_bytes=mine["host_peak_bytes"],
             device_peak_bytes=None),
        dict(rank=1, initialization=start + 2.5, host_peak_bytes=7,
             device_peak_bytes=9)]


def test_a_one_rank_report_lists_its_rank(tmp_path):
    """A one-rank run's perf JSON lists its own start and peaks under
    `ranks`, as a run of several lists each rank's."""
    import json

    from pace_torch.driver.performance import PerformanceCollector

    collector = PerformanceCollector("one", device="cpu")
    with collector.total_timer.clock("initialization"):
        pass
    mine = collector.times()
    collector.write_out_performance("torch/cpu", 225.0, str(tmp_path))
    report = json.loads((tmp_path / "one_perf.json").read_text())
    (rank,) = report["ranks"]
    assert rank["rank"] == 0 and rank["device_peak_bytes"] is None
    assert rank["initialization"] == mine["total_times"]["initialization"]
    assert 0 < mine["host_peak_bytes"] <= rank["host_peak_bytes"]
