"""The port's comparison, selective-validation, nudging and monitor
utilities, its native restart writer and `driver.tools`, held against the
reference package on the same seeded numpy inputs:

- utils.testing (compare_arr, compare_scalar, success_array with its
  exact-equal and NaN-pair rules, perturb), utils.functional_validation
  and utils.nudging give the reference's results, on arrays and on
  tensors;
- NpzMonitor series and write_state files read back equal through the
  reference's readers, and the reference's through the port's;
- fastpack's .npy files equal numpy.save's byte for byte, load with
  numpy.load and through pace_tpu.driver.restart.load_restart_arrays;
- `python -m pace_torch.driver.tools` on examples/configs/baroclinic_c12.yaml
  on the CPU: the argument bytes are the state's and K-T/K-S/K-F are each
  counted as often as a step of that configuration launches them (7/2/1).
"""

import os
from datetime import timedelta

import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads
from pace_torch.utils import functional_validation as fv
from pace_torch.utils import monitor, nudging, testing
from pace_torch.utils.gridtools import GridSizing
from pace_tpu.utils import functional_validation as ref_fv
from pace_tpu.utils import monitor as ref_monitor
from pace_tpu.utils import nudging as ref_nudging
from pace_tpu.utils import testing as ref_testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def _pair(seed=5, shape=(4, 6, 5)):
    """Two nearby arrays with the metric's special cases planted: exact
    zeros, equal values, NaN pairs, a lone NaN, equal infinities, values
    below a near-zero floor."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(*shape)
    got = ref * (1.0 + 1e-9 * rng.randn(*shape))
    ref[0, 0, :2] = got[0, 0, :2] = 0.0
    got[0, 1, 0] = ref[0, 1, 0]
    ref[0, 2, 0] = got[0, 2, 0] = np.nan
    got[0, 2, 1] = np.nan
    ref[0, 3, 0] = got[0, 3, 0] = np.inf
    ref[1, 0, :3] = 1e-20
    got[1, 0, :3] = -3e-20
    return got, ref


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_comparison_metric_matches_reference(kind):
    got, ref = _pair()
    wrap = (lambda a: a) if kind == "numpy" else torch.as_tensor
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(
            testing.compare_arr(wrap(got), wrap(ref)),
            ref_testing.compare_arr(got, ref))
        for eps, ignore, near in ((1e-8, False, 1e-18), (1e-10, True, 1e-19),
                                  (1e-10, False, 1e-19)):
            np.testing.assert_array_equal(
                testing.success_array(wrap(got), wrap(ref), eps, ignore,
                                      near),
                ref_testing.success_array(got, ref, eps, ignore, near))
    assert testing.compare_scalar(1.0 + 1e-12, 1.0) == \
        ref_testing.compare_scalar(1.0 + 1e-12, 1.0)
    flags = np.array([True, False, True])
    np.testing.assert_array_equal(
        testing.compare_arr(flags, ~flags),
        ref_testing.compare_arr(flags, ~flags))
    with pytest.raises(TypeError):
        testing.compare_arr(np.array(["a"]), np.array(["b"]))


def test_perturb_matches_reference():
    rng = np.random.RandomState(2)
    state = {"pt": rng.randn(3, 4), "n": np.arange(4)}
    for seed in (0, 3):
        ours = testing.perturb(state, scale=1e-12, seed=seed)
        theirs = ref_testing.perturb(state, scale=1e-12, seed=seed)
        assert sorted(ours) == sorted(theirs)
        for name in state:
            np.testing.assert_array_equal(ours[name], theirs[name])
    tensors = testing.perturb({k: torch.as_tensor(v)
                               for k, v in state.items()}, seed=3)
    np.testing.assert_array_equal(tensors["pt"],
                                  ref_testing.perturb(state, seed=3)["pt"])


_WINDOWS = [(("x", "y", "z"), ((0, 0), (0, 0))),
            (("x", "y_interface", "z"), ((0, 0), (0, 0))),
            (("x_interface", "y", "z"), ((1, 2), (0, 1))),
            (("x", "y", "z"), ((3, 3), (3, 3)))]


@pytest.mark.parametrize("dims,n_halo", _WINDOWS)
def test_selective_validation_matches_reference(dims, n_halo):
    sizing = GridSizing(12, 4)
    data = np.random.RandomState(4).randn(6, sizing.N, sizing.N, 4)
    t = torch.as_tensor(data)
    subset = fv.get_subset_func(sizing, dims, n_halo)
    expect = ref_fv.get_subset_func(sizing, dims, n_halo)(data)
    np.testing.assert_array_equal(subset(data), expect)
    assert isinstance(subset(t), torch.Tensor)
    np.testing.assert_array_equal(subset(t).numpy(), expect)

    set_nans = fv.get_set_nan_func(sizing, dims, n_halo)
    expect = ref_fv.get_set_nan_func(sizing, dims, n_halo)(data)
    np.testing.assert_array_equal(set_nans(data), expect)
    out = set_nans(t)
    assert isinstance(out, torch.Tensor) and out.dtype == t.dtype
    np.testing.assert_array_equal(out.numpy(), expect)

    other = data.copy()
    inside = subset(other)
    other[:, -1, -1] += 999.0   # outside every window above
    fv.selective_compare(data, torch.as_tensor(other), sizing, dims, n_halo)
    ref_fv.selective_compare(data, other, sizing, dims, n_halo)
    inside += 1.0
    for compare in (fv.selective_compare, ref_fv.selective_compare):
        with pytest.raises(AssertionError):
            compare(data, other, sizing, dims, n_halo)


def test_nudging_matches_reference():
    rng = np.random.RandomState(6)
    state = {name: rng.randn(3, 4) for name in ("pt", "delp", "u")}
    reference = {name: rng.randn(3, 4) for name in state}
    scales = {"pt": timedelta(seconds=600.0), "delp": 3600.0}
    tend = nudging.get_nudging_tendencies(
        {k: torch.as_tensor(v) for k, v in state.items()},
        {k: torch.as_tensor(v) for k, v in reference.items()}, scales)
    expect = ref_nudging.get_nudging_tendencies(state, reference, scales)
    assert sorted(tend) == sorted(expect)
    for name in expect:
        np.testing.assert_array_equal(tend[name].numpy(), expect[name])
    before = {k: torch.as_tensor(v) for k, v in state.items()}
    new, tend = nudging.apply_nudging(
        before, {k: torch.as_tensor(v) for k, v in reference.items()},
        scales, timedelta(seconds=225.0))
    new_ref, _ = ref_nudging.apply_nudging(state, reference, scales, 225.0)
    for name in state:
        np.testing.assert_array_equal(new[name].numpy(), new_ref[name])
        np.testing.assert_array_equal(before[name].numpy(), state[name])
    for module in (nudging, ref_nudging):
        with pytest.raises(ValueError, match="nope"):
            module.apply_nudging(state, reference, {"nope": 1.0}, 1.0)


def test_monitor_files_read_in_both_packages(tmp_path):
    rng = np.random.RandomState(7)
    series = [{"time": f"t{i}", "pt": torch.as_tensor(rng.randn(2, 3)),
               "n": np.arange(3) + i} for i in range(2)]
    mon = monitor.NpzMonitor(str(tmp_path / "port"))
    for state in series:
        mon.store(state)
    for reader in (monitor.NpzMonitor, ref_monitor.NpzMonitor):
        times, states = reader.read(str(tmp_path / "port"))
        assert times == ["t0", "t1"]
        for got, state in zip(states, series):
            np.testing.assert_array_equal(got["pt"], state["pt"].numpy())
            np.testing.assert_array_equal(got["n"], state["n"])
    ref_mon = ref_monitor.NpzMonitor(str(tmp_path / "ref"))
    ref_mon.store({"time": "t0", "pt": series[0]["pt"].numpy()})
    times, states = monitor.NpzMonitor.read(str(tmp_path / "ref"))
    assert times == ["t0"]
    np.testing.assert_array_equal(states[0]["pt"], series[0]["pt"].numpy())
    monitor.DummyMonitor().store(series[0])

    path = str(tmp_path / "state.npz")
    monitor.write_state({"time": "2000-01-01", "pt": series[0]["pt"]}, path)
    for read in (monitor.read_state, ref_monitor.read_state):
        state = read(path)
        assert state["time"] == "2000-01-01"
        np.testing.assert_array_equal(state["pt"], series[0]["pt"].numpy())
    with pytest.raises(ValueError):
        monitor.write_state({"pt": series[0]["pt"]}, path)
    assert monitor.NetCDFMonitor is not None


def test_fastpack_files_read_by_numpy_and_the_reference(tmp_path):
    import dataclasses

    from pace_torch._native import fastpack
    from pace_torch.driver.restart import load_restart_arrays, write_restart
    from pace_tpu.driver.restart import load_restart_arrays as ref_load

    rng = np.random.RandomState(8)
    arrays = {"pt": rng.randn(6, 5, 4).astype(np.float32),
              "delp": rng.randn(6, 5), "ks": np.arange(3, dtype=np.int32),
              "nstep": np.array(7, dtype=np.int64)}
    fastpack.write_state_npys(str(tmp_path / "fp"), arrays)
    for name, arr in arrays.items():
        np.save(str(tmp_path / f"{name}.npy"), arr)
        path = str(tmp_path / "fp" / f"{name}.npy")
        with open(path, "rb") as a, open(str(tmp_path / f"{name}.npy"),
                                         "rb") as b:
            assert a.read() == b.read(), name
        np.testing.assert_array_equal(fastpack.read_npy(path), arr)
    with pytest.raises(TypeError):
        fastpack.write_npy(str(tmp_path / "b.npy"), np.zeros(2, bool))

    @dataclasses.dataclass
    class State:
        pt: torch.Tensor
        delp: torch.Tensor

    state = State(pt=torch.as_tensor(arrays["pt"]),
                  delp=torch.as_tensor(arrays["delp"]))
    write_restart(state, "2000-01-01", str(tmp_path / "R"))
    assert sorted(os.listdir(tmp_path / "R" / "dycore_state")) == [
        "delp.npy", "pt.npy"]
    for load in (load_restart_arrays, ref_load):
        back = load(str(tmp_path / "R"))
        for name in ("pt", "delp"):
            np.testing.assert_array_equal(back[name], arrays[name])
            assert back[name].dtype == arrays[name].dtype


def test_fastpack_raises_where_it_cannot_be_built(tmp_path, monkeypatch):
    from pace_torch._native import fastpack

    monkeypatch.setattr(fastpack, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(fastpack, "_LIB", None)
    monkeypatch.setattr(fastpack.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        fastpack.write_npy(str(tmp_path / "a.npy"), np.zeros(2))


def test_tools_report_the_state_and_the_kernels(tmp_path, monkeypatch):
    """One Driver.step() of baroclinic_c12.yaml on the CPU under the
    counting mode: the memory report's bytes are the state's, the CPU has
    no temporary-memory figure, and each kernel is counted as launched by
    a step of the configuration (k_split 1, n_split 1: 7/2/1)."""
    from pace_torch.driver import tools
    from pace_torch.models.fv3.state import zeros_numpy

    monkeypatch.chdir(tmp_path)
    path = os.path.join(REPO, "examples", "configs", "baroclinic_c12.yaml")
    driver = tools.build_driver(path, device="cpu")
    state_bytes = 8 * sum(a.size for a in
                          zeros_numpy(GridSizing(12, 79)).values())
    report = tools.step_report(driver, count=True)
    assert report["argument_size_in_bytes"] == state_bytes
    assert report["output_size_in_bytes"] == state_bytes
    assert report["temp_size_in_bytes"] is None
    assert report["peak_size_in_bytes"] is None
    assert report["generated_code_size_in_bytes"] is None
    counts = {k: v["launches"] for k, v in report["kernels"].items()}
    assert counts == {"K-T": 7, "K-S": 2, "K-F": 1}
    kernels = report["kernels"]
    assert report["launches"] > sum(counts.values())
    assert report["bytes accessed"] > sum(k["bytes"] for k in
                                          kernels.values()) > 0
    assert report["flops"] > sum(k["flops"] for k in kernels.values()) > 0
    assert report["optimal_seconds"] == max(
        report["bytes accessed"] / 3.35e12, report["flops"] / 67e12)
    assert tools.build_parser().parse_args(["cost", "c.yaml"]).device == \
        "cuda"
