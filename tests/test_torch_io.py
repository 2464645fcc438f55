"""Files written by the port read back equal in the reference package, and
the other way round: npz, NetCDF and Zarr diagnostics (with a column
integral, a vertical slice and the grid) and both restart forms, on a
seeded C12 state in float64 and float32."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads

N_, NZ = 12, 79
FORMATS = ("npz", "netcdf", "zarr")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


def _arrays(dtype) -> dict:
    from pace_torch.models.fv3.state import zeros_numpy
    from pace_torch.utils.gridtools import GridSizing

    rng = np.random.default_rng(17)
    return {name: rng.uniform(0.5, 2.0, a.shape).astype(dtype)
            for name, a in zeros_numpy(GridSizing(N_, NZ)).items()}


def _diag_config(pkg, path, fmt):
    mod = __import__(f"{pkg}.driver.diagnostics", fromlist=["x"])
    return mod.DiagnosticsConfig(
        path=str(path), output_format=fmt, names=["u", "v", "pt", "ps"],
        derived_names=["column_integrated_qvapor"],
        z_select=[mod.ZSelect(level=5, names=["pt"])])


def _write_diagnostics(pkg, path, fmt, arrays):
    """Two records and the grid, written by package `pkg`."""
    if pkg == "pace_torch":
        from pace_torch.grid.generation import grid_arrays_numpy
        from pace_torch.utils.gridtools import GridSizing

        sizing = GridSizing(N_, NZ)
        state = types.SimpleNamespace(
            **{k: torch.tensor(v) for k, v in arrays.items()})
        hz = {k: torch.tensor(v) for k, v in
              grid_arrays_numpy(N_, NZ)["horizontal"].items()}
    else:
        from pace_torch.grid.generation import grid_arrays_numpy
        from pace_tpu.utils.gridtools import GridSizing

        sizing = GridSizing(N_, NZ)
        state = types.SimpleNamespace(**arrays)
        hz = grid_arrays_numpy(N_, NZ)["horizontal"]
    diags = _diag_config(pkg, path, fmt).diagnostics_factory(sizing)
    diags.store("2000-01-01 00:00:00", state)
    diags.store("2000-01-01 00:03:45", state)
    diags.store_grid(types.SimpleNamespace(
        horizontal=types.SimpleNamespace(**hz)))
    diags.cleanup()


def _read_diagnostics(pkg, path, fmt) -> dict:
    """{record or "grid": {name: array}} read with package `pkg`'s
    readers."""
    netcdf = __import__(f"{pkg}.utils.netcdf", fromlist=["x"])
    zarrlite = __import__(f"{pkg}.utils.zarrlite", fromlist=["x"])
    out = {}
    if fmt == "npz":
        for fname in sorted(os.listdir(path)):
            with np.load(os.path.join(path, fname)) as data:
                out[fname] = {k: data[k] for k in data.files}
    elif fmt == "netcdf":
        times, states = netcdf.NetCDFMonitor.read(str(path))
        for time, state in zip(times, states):
            out[time] = state
        out["grid"] = netcdf.read_dataset(os.path.join(path, "grid.nc"))
    else:
        for store in ("state.zarr", "grid.zarr"):
            root = os.path.join(path, store)
            out[store] = {
                name: zarrlite.read_zarr_array(os.path.join(root, name))
                for name in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, name))}
    return out


def _assert_same(a: dict, b: dict, rtol=0.0):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_same(a[key], b[key], rtol)
            continue
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_diagnostics_cross_read(tmp_path, fmt, dtype):
    arrays = _arrays(dtype)
    written = {}
    for pkg in ("pace_torch", "pace_tpu"):
        _write_diagnostics(pkg, tmp_path / pkg, fmt, arrays)
        reads = [_read_diagnostics(reader, tmp_path / pkg, fmt)
                 for reader in ("pace_torch", "pace_tpu")]
        # each package's files read back the same in either package
        _assert_same(reads[0], reads[1])
        written[pkg] = reads[0]
    # and both packages wrote the same values: the fields exactly, the
    # column integral (a sum taken by torch or by numpy) to round-off
    flat = {pkg: {f"{rec}/{name}": v for rec, fields in w.items()
                  for name, v in fields.items()}
            for pkg, w in written.items()}
    integral = {pkg: {k: v for k, v in f.items() if "column" in k}
                for pkg, f in flat.items()}
    plain = {pkg: {k: v for k, v in f.items() if "column" not in k}
             for pkg, f in flat.items()}
    assert integral["pace_torch"]
    _assert_same(plain["pace_torch"], plain["pace_tpu"])
    _assert_same(integral["pace_torch"], integral["pace_tpu"],
                 rtol=1e-14 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fmt", ["npz", "netcdf"])
def test_restart_cross_read(tmp_path, fmt, dtype):
    import jax.numpy as jnp

    from pace_torch.driver import restart
    from pace_torch.driver.initialization import RestartInit
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.utils.gridtools import GridSizing
    from pace_tpu.driver import restart as ref_restart
    from pace_tpu.driver.initialization import RestartInit as RefInit
    from pace_tpu.models.fv3.state import DycoreState as RefState
    from pace_tpu.utils.gridtools import GridSizing as RefSizing

    arrays = _arrays(dtype)
    restart.write_restart(
        DycoreState.from_numpy(arrays, "cpu", getattr(torch, dtype.__name__)),
        "2000-01-01 00:03:45", str(tmp_path / "pace_torch"), fmt)
    ref_restart.write_restart(RefState(**arrays), "2000-01-01 00:03:45",
                              str(tmp_path / "pace_tpu"), fmt)
    for writer in ("pace_torch", "pace_tpu"):
        path = str(tmp_path / writer)
        for loader in (restart.load_restart_arrays,
                       ref_restart.load_restart_arrays):
            _assert_same(loader(path), arrays)
        # and each package starts a run from the other's restart
        port = RestartInit(path=path).get_dycore_state(
            GridSizing(N_, NZ), "cpu", torch.float64)
        ref = RefInit(path=path).get_dycore_state(RefSizing(N_, NZ),
                                                  jnp.float64)
        for f in dataclasses.fields(port):
            want = arrays[f.name].astype(np.float64)
            np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                          want, err_msg=f.name)
            np.testing.assert_array_equal(np.asarray(getattr(ref, f.name)),
                                          want, err_msg=f.name)
