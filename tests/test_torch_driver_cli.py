"""The port's yaml entry point, `python -m pace_torch.driver.run`, on the
CPU at C12: examples/configs/baroclinic_c12.yaml for one step (only the
output paths and the run length changed) writes the diagnostics, the
performance report and the restart; the same run with the dycore alone
(the settings of tests/golden/c12_dycore_digest.json: C12/79 float64,
dt 225 s, do_sat_adj=False) restarts within 1e-9 of the digest's step 1
and reports its sections; without sections the step synchronises the
device once, with them at each phase; a state that leaves the bounds
fails the safety check with the reference package's message; and a run
whose step crashes still writes its report and restart."""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from pace_torch.testing import digest_errors, state_digest, torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = 32


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(2):
        yield


def _example(tmp, **changes) -> str:
    """examples/configs/baroclinic_c12.yaml for one step, its outputs under
    `tmp`, with `changes` applied; returns the yaml's path."""
    with open(os.path.join(REPO, "examples", "configs",
                           "baroclinic_c12.yaml")) as f:
        config = yaml.safe_load(f)
    config.update(minutes=0, seconds=225)
    config["diagnostics_config"]["path"] = str(tmp / "output")
    config["restart_config"]["path"] = str(tmp / "RESTART")
    for key, value in changes.items():
        if isinstance(value, dict):
            config.setdefault(key, {}).update(value)
        else:
            config[key] = value
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _run(tmp, monkeypatch, **changes):
    from pace_torch.driver.run import main

    path = _example(tmp, **changes)
    monkeypatch.chdir(tmp)   # the perf JSON is written to the current dir
    return main([path, "--device", "cpu", "--log-level", "WARNING"])


def _run_recording_syncs(tmp, **changes) -> list:
    """Runs the example and returns, in order, each timer clock started
    (a timer synchronises the device at its start and stop) and "step
    end" for each synchronisation `step_all` makes after a step."""
    from pace_torch.driver.driver import Driver
    from pace_torch.utils.timing import Timer

    syncs = []
    start, synchronize = Timer.start, Driver._synchronize

    def recording_start(self, name):
        if self.enabled:
            syncs.append(name)
        start(self, name)

    def recording_synchronize(self):
        syncs.append("step end")
        synchronize(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Timer, "start", recording_start)
        mp.setattr(Driver, "_synchronize", recording_synchronize)
        assert _run(tmp, mp, **changes) == 0
    return syncs


@pytest.fixture(scope="module")
def as_written(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("as_written")
    return tmp, _run_recording_syncs(tmp)


@pytest.fixture(scope="module")
def dycore_alone(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dycore_alone")
    return tmp, _run_recording_syncs(
        tmp, dycore_only=True, safety_check_frequency=1,
        performance_config=dict(sections=True))


def test_without_sections_a_step_synchronises_once(as_written):
    """sections: false adds no synchronisation to the step: the device is
    synchronised once a step, when the step's time is read."""
    _, syncs = as_written
    assert syncs == ["initialization", "total", "step end"]


def test_sections_synchronise_at_each_phase(dycore_alone):
    _, syncs = dycore_alone
    assert syncs == ["initialization", "total", "DynCore",
                     "TracerAdvection", "Remapping", "step end"]


def test_run_writes_the_initial_diagnostics_and_the_grid(as_written):
    out = as_written[0] / "output"
    # output_frequency 2: one step writes the initial state only
    assert sorted(os.listdir(out)) == ["grid.npz", "state_000000.npz"]
    state = np.load(out / "state_000000.npz")
    assert sorted(state.files) == ["ps", "pt", "time", "ua", "va"]
    for name in ("ps", "pt", "ua", "va"):
        assert state[name].shape[:3] == (6, 12, 12), name
        assert np.isfinite(state[name]).all(), name
    assert str(state["time"]) == "2000-01-01 00:00:00"
    grid = np.load(out / "grid.npz")
    assert sorted(grid.files) == ["area", "lat", "lat_agrid", "lon",
                                  "lon_agrid"]


def test_run_writes_the_performance_report(as_written):
    report = json.loads(
        (as_written[0] / "c12_baroclinic_perf.json").read_text())
    assert report["backend"] == "torch/cpu"
    assert report["sypd"] > 0.0
    assert len(report["times_per_step"]) == 1
    assert list(report["times_per_step"][0]) == ["mainloop"]
    assert set(report["total_times"]) == {"initialization", "total"}


def test_run_writes_the_final_restart(as_written):
    from pace_torch.driver.restart import load_restart_arrays

    arrays = load_restart_arrays(str(as_written[0] / "RESTART"))
    assert len(arrays) == FIELDS
    assert all(a.dtype == np.float64 for a in arrays.values())
    h, n = 3, 12
    for name in ("u", "v", "pt", "delp", "qvapor"):
        assert np.isfinite(arrays[name][:, h:h + n, h:h + n]).all(), name
    time = json.loads(
        (as_written[0] / "RESTART" / "time.json").read_text())
    assert time == {"time": "2000-01-01 00:03:45"}


def test_dycore_restart_matches_the_golden_digest(dycore_alone):
    from pace_torch.driver.restart import load_restart_arrays
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.utils.gridtools import GridSizing

    with open(os.path.join(REPO, "tests", "golden",
                           "c12_dycore_digest.json")) as f:
        golden = json.load(f)
    state = DycoreState.from_numpy(
        load_restart_arrays(str(dycore_alone[0] / "RESTART")), "cpu",
        torch.float64)
    errs = digest_errors(state_digest(state, GridSizing(12, 79)),
                         golden["step1"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-9, (worst, errs[worst])


def test_sections_report_each_phase(dycore_alone):
    report = json.loads(
        (dycore_alone[0] / "c12_baroclinic_perf.json").read_text())
    (step,) = report["times_per_step"]
    assert set(step) == {"mainloop", "DynCore", "TracerAdvection",
                         "Remapping"}
    sections = step["DynCore"] + step["TracerAdvection"] + step["Remapping"]
    assert all(v > 0.0 for v in step.values())
    assert sections <= step["mainloop"]


def test_out_of_bounds_pt_fails_with_the_reference_message():
    from pace_torch.driver.safety_checks import (
        SafetyChecker,
        register_default_checks,
    )
    from pace_torch.utils.gridtools import GridSizing
    from pace_tpu.driver import driver as ref_driver
    from pace_tpu.driver.safety_checks import SafetyChecker as RefChecker
    from pace_tpu.utils.gridtools import GridSizing as RefSizing

    rng = np.random.default_rng(5)
    shape = (6, 24, 24, 79)
    arrays = dict(pt=rng.uniform(200.0, 300.0, shape),
                  delp=rng.uniform(1.0, 10.0, shape),
                  u=rng.uniform(-50.0, 50.0, shape),
                  v=rng.uniform(-50.0, 50.0, shape))
    arrays["pt"][2, 7, 9, 40] = 412.5
    arrays["pt"][0, 0, 0, 0] = 900.0     # a halo cell: not checked
    register_default_checks()
    ref_driver._register_default_checks()
    messages = []
    for checker, state in (
            (SafetyChecker(GridSizing(12, 79)), types.SimpleNamespace(
                **{k: torch.tensor(v) for k, v in arrays.items()})),
            (RefChecker(RefSizing(12, 79)), types.SimpleNamespace(**arrays))):
        with pytest.raises(RuntimeError) as info:
            checker.check_state(state)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert messages[0] == ("Variable pt is outside of its specified bounds: "
                           "412.5 > 350.0")


def test_a_crashed_run_still_writes_its_report_and_restart(
        tmp_path, monkeypatch):
    """A step that raises ends the run with its exception; run.py's
    try/finally still writes the performance report, the grid and the
    final restart, which holds the last completed state (here the
    initial one)."""
    from pace_torch.driver.restart import load_restart_arrays
    from pace_torch.models.fv3 import dynamics

    def failing_step(self, state):
        raise RuntimeError("the step failed")

    monkeypatch.setattr(dynamics.DynamicalCore, "step_dynamics",
                        failing_step)
    with pytest.raises(RuntimeError, match="the step failed"):
        _run(tmp_path, monkeypatch, dycore_only=True)
    report = json.loads((tmp_path / "c12_baroclinic_perf.json").read_text())
    assert report["times_per_step"] == []
    assert (tmp_path / "output" / "grid.npz").exists()
    arrays = load_restart_arrays(str(tmp_path / "RESTART"))
    assert len(arrays) == FIELDS
    time = json.loads((tmp_path / "RESTART" / "time.json").read_text())
    assert time == {"time": "2000-01-01 00:00:00"}
