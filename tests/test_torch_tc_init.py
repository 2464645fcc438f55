"""The port's tropical-cyclone start, stretched grid and eta-file grid
against the reference package's at C12: the same numpy arithmetic, so
every field is held to 1e-12 of its scale (and is in fact bit-identical).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads

N_, NZ, H = 12, 79, 3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


def _leaves(gd) -> dict:
    """{bundle.field: numpy array or scalar} of either package's GridData."""
    out = {}
    for bundle in ("horizontal", "angle", "damping", "vertical"):
        b = getattr(gd, bundle)
        for f in dataclasses.fields(b):
            v = getattr(b, f.name)
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            out[f"{bundle}.{f.name}"] = np.asarray(v, np.float64)
    return out


def _assert_close(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        scale = float(np.nanmax(np.abs(r))) if r.size else 0.0
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * scale + 1e-300,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tc_states():
    from pace_torch.models.fv3.init.tropical_cyclone import init_tc_state
    from pace_torch.utils.gridtools import GridSizing
    from pace_tpu.models.fv3.init.tropical_cyclone import (
        init_tc_state as ref_init,
    )
    from pace_tpu.utils.gridtools import GridSizing as RefSizing

    port = init_tc_state(GridSizing(N_, NZ), device="cpu",
                         dtype=torch.float64)
    ref = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    return port, ref


def test_tc_state_matches_the_reference(tc_states):
    port, ref = tc_states
    got = {f.name: getattr(port, f.name).numpy()
           for f in dataclasses.fields(port)}
    want = {f.name: np.asarray(getattr(ref, f.name))
            for f in dataclasses.fields(ref)}
    _assert_close(got, want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_tc_state_has_its_vortex(tc_states):
    """The lowest surface pressure lies in the cell nearest the vortex
    centre (180E, 10N), and the core is warmer than the far field."""
    from pace_torch.grid.generation import grid_arrays_numpy
    from pace_torch.models.fv3.init.tropical_cyclone import TC

    port, _ = tc_states
    c = (slice(None), slice(H, H + N_), slice(H, H + N_))
    ps, pt = port.ps[c].numpy(), port.pt[c].numpy()
    hz = grid_arrays_numpy(N_, NZ)["horizontal"]
    lon, lat = hz["lon_agrid"][c], hz["lat_agrid"][c]
    lon0, lat0 = np.deg2rad(TC["lon_tc"]), np.deg2rad(TC["lat_tc"])
    cos_d = (np.sin(lat) * np.sin(lat0)
             + np.cos(lat) * np.cos(lat0) * np.cos(lon - lon0))
    nearest = np.unravel_index(np.argmax(cos_d), ps.shape)
    assert np.unravel_index(np.argmin(ps), ps.shape) == nearest
    assert ps.min() < TC["p_ref"] - 100.0
    assert pt[nearest + (60,)] > np.median(pt[..., 60])


def test_stretched_grid_matches_the_reference():
    from pace_torch.grid.generation import generate_grid_data
    from pace_tpu.grid.generation import generate_grid_data as ref_grid

    kw = dict(stretch_factor=3.0, lon_target=350.0, lat_target=-90.0)
    port = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float64,
                              **kw)
    ref = ref_grid(N_, NZ, dtype=jnp.float64, **kw)
    _assert_close(_leaves(port), _leaves(ref))
    plain = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float64)
    assert port.damping.da_min < 0.5 * plain.damping.da_min


def test_eta_file_grid_matches_the_reference(tmp_path):
    """An ak/bk table written as NetCDF3 (as tests/test_grid_options.py
    writes it) drives both packages' vertical grid at 10 levels."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.utils.netcdf import write_dataset
    from pace_tpu.grid.generation import generate_grid_data as ref_grid

    nz = 10
    ak = np.linspace(100.0, 0.0, nz + 1)
    bk = np.concatenate([np.zeros(3), np.linspace(0.0, 1.0, nz - 2)])
    path = str(tmp_path / "eta10.nc")
    write_dataset(path, {"ak": ak, "bk": bk})
    port = generate_grid_data(N_, nz, device="cpu", dtype=torch.float64,
                              eta_file=path)
    ref = ref_grid(N_, nz, dtype=jnp.float64, eta_file=path)
    _assert_close(_leaves(port), _leaves(ref))
    np.testing.assert_array_equal(port.vertical.ak.numpy(), ak)
    assert port.vertical.ks == 3 and port.vertical.ptop == 100.0
    with pytest.raises(NotImplementedError):
        generate_grid_data(N_, nz, device="cpu")
