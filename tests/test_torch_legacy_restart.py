"""The Fortran restart start in the port, after tests/test_legacy_restart.py:
tile-sharded NetCDF3 restart files written with scipy, read back by
`pace_torch.utils.legacy_restart.open_restart` and by the reference's on
the same files, and through the `fortran_restart` initializer.

Every value encodes its tile, level and position (tile * 1e6 + z * 1e4 +
y * 100 + x, plus a per-variable offset), so a swapped or transposed axis
cannot pass."""

import numpy as np
import pytest
import torch

N_, NZ, H = 6, 5, 3

# (variable, file, dims in Fortran order (Time, z, y, x), x/y extents)
VARIABLES = [
    ("u", "fv_core.res", ("Time", "zaxis_1", "yaxis_2", "xaxis_1"), N_, N_ + 1),
    ("v", "fv_core.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_2"), N_ + 1, N_),
    ("T", "fv_core.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"), N_, N_),
    ("delp", "fv_core.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"), N_, N_),
    ("W", "fv_core.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"), N_, N_),
    ("DZ", "fv_core.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"), N_, N_),
    ("phis", "fv_core.res", ("Time", "yaxis_1", "xaxis_1"), N_, N_),
    ("sphum", "fv_tracer.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"),
     N_, N_),
    ("liq_wat", "fv_tracer.res", ("Time", "zaxis_1", "yaxis_1", "xaxis_1"),
     N_, N_),
    ("u_srf", "fv_srf_wnd.res", ("Time", "yaxis_1", "xaxis_1"), N_, N_),
]


def _values(tile, index, dims, nx, ny):
    """(1[, nz], ny, nx) float64: each value names where it belongs."""
    a = (tile * 1e6 + index * 1e7 + np.arange(ny)[:, None] * 100.0
         + np.arange(nx)[None, :])
    if len(dims) == 4:
        a = np.arange(NZ)[:, None, None] * 1e4 + a[None]
    return a[None]


def _write(path, variables):
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as nc:
        made = set()
        for name, (dims, data) in variables.items():
            for d, size in zip(dims, data.shape):
                if d not in made:
                    nc.createDimension(d, size)
                    made.add(d)
            nc.createVariable(name, "d", dims)[:] = data


@pytest.fixture()
def restart_dir(tmp_path):
    truth = {}
    for tile in range(1, 7):
        files = {}
        for index, (name, fname, dims, nx, ny) in enumerate(VARIABLES):
            data = _values(tile, index, dims, nx, ny)
            files.setdefault(fname, {})[name] = (dims, data)
            truth[tile, name] = data[0]
        for fname, variables in files.items():
            _write(tmp_path / f"{fname}.tile{tile}.nc", variables)
    (tmp_path / "coupler.res").write_text(
        "     2        (Calendar: no_calendar=0, thirty_day_months=1, "
        "julian=2, gregorian=3, noleap=4)\n"
        "  2016     8     1     0     0     0        Model start time\n"
        "  2016     8     3     6    30     0        Current model time\n"
    )
    return tmp_path, truth


def _fortran(a):
    """(z, y, x) or (y, x) -> the storage's (x, y[, z])."""
    return np.transpose(a, (2, 1, 0)) if a.ndim == 3 else a.T


def test_open_restart_round_trip(restart_dir):
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.utils.legacy_restart import RESTART_TO_FIELD, open_restart
    from pace_tpu.utils.gridtools import GridSizing as RefSizing
    from pace_tpu.utils.legacy_restart import open_restart as ref_open

    path, truth = restart_dir
    state = open_restart(str(path), GridSizing(N_, NZ, H), dtype=np.float64)
    t = state.pop("time")
    assert (t.year, t.month, t.day, t.hour, t.minute) == (2016, 8, 3, 6, 30)
    ref = ref_open(str(path), RefSizing(N_, NZ, H), dtype=np.float64)
    assert ref.pop("time") == t
    assert sorted(state) == sorted(ref)
    for name in ref:
        if state[name].ndim == 3:
            # a surface field: the reference keeps its Time axis as a
            # trailing level of size 1 (ROADMAP Queue 3)
            assert ref[name].shape == state[name].shape + (1,)
            np.testing.assert_array_equal(state[name], ref[name][..., 0])
        else:
            np.testing.assert_array_equal(state[name], ref[name])

    for (tile, rn), data in truth.items():
        field, (ex, ey) = RESTART_TO_FIELD[rn]
        got = state[field][tile - 1, H:H + N_ + ex, H:H + N_ + ey]
        np.testing.assert_array_equal(got, _fortran(data))
    # halos stay zero
    assert np.all(state["delp"][:, :H] == 0) and np.all(
        state["delp"][:, :, H + N_:] == 0)


def test_only_names_subset(restart_dir):
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.utils.legacy_restart import open_restart

    path, _ = restart_dir
    state = open_restart(str(path), GridSizing(N_, NZ, H),
                         only_names=["pt", "delp"])
    assert set(state) == {"pt", "delp", "time"}


def test_fortran_restart_initializer(restart_dir):
    """The {"type": "fortran_restart"} start fills a DycoreState on the
    requested device and dtype; what the files do not hold is zero."""
    from pace_torch.driver.initialization import InitializerSelector
    from pace_torch.utils.gridtools import GridSizing

    path, truth = restart_dir
    init = InitializerSelector.from_dict(
        {"type": "fortran_restart", "config": {"path": str(path)}})
    assert init.start_time.year == 2016 and init.start_time.day == 3
    state = init.get_dycore_state(GridSizing(N_, NZ, H), "cpu",
                                  torch.float64)
    assert state.dtype == torch.float64 and state.device.type == "cpu"
    got = state.pt.numpy()[3, H:H + N_, H:H + N_, :]
    np.testing.assert_array_equal(got, _fortran(truth[4, "T"]))
    got = state.qliquid.numpy()[5, H:H + N_, H:H + N_, :]
    np.testing.assert_array_equal(got, _fortran(truth[6, "liq_wat"]))
    got = state.phis.numpy()[0, H:H + N_, H:H + N_]
    np.testing.assert_array_equal(got, _fortran(truth[1, "phis"]))
    assert float(state.pe.abs().max()) == 0.0
    # a start time in the configuration wins over coupler.res
    init = InitializerSelector.from_dict(
        {"type": "fortran_restart",
         "config": {"path": str(path),
                    "start_time_str": "2020-01-02 03:04:05"}})
    assert init.start_time.year == 2020
