"""The port's jax-free init (topology tables, corner tables, C12 grid data,
baroclinic initial state) against the reference package's, and the
numpy bridge between the two packages.  The arithmetic is the same numpy
code, so every comparison is exact."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import generate_grid_data as ref_grid
from pace_tpu.models.fv3.init.baroclinic import (
    init_baroclinic_state as ref_init,
)
from pace_tpu.ops import corners as ref_corners
from pace_tpu.parallel.topology import CubedSphereTopology as RefTopology
from pace_tpu.utils.gridtools import GridSizing as RefSizing
from pace_torch.grid.generation import GridData, generate_grid_data
from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
from pace_torch.models.fv3.state import DycoreState
from pace_torch.ops import corners
from pace_torch.parallel.topology import CubedSphereTopology
from pace_torch.utils.gridtools import GridSizing

N_, NZ, H = 12, 79, 3
SPEC_FIELDS = ("src_tile", "src_i", "src_j", "src_comp", "sign", "valid")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _assert_spec_equal(a, b):
    for name in SPEC_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)


def _grid_leaves(gd) -> dict:
    """Nested numpy leaves {bundle: {field: array or scalar}} of either
    package's GridData."""
    out = {}
    for bundle in ("horizontal", "angle", "damping", "vertical"):
        b = getattr(gd, bundle)
        out[bundle] = {}
        for f in dataclasses.fields(b):
            v = getattr(b, f.name)
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            out[bundle][f.name] = (np.asarray(v) if hasattr(v, "shape")
                                   else v)
    return out


def _state_leaves(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_leaves_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_leaves_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def ref_grid64():
    return ref_grid(N_, NZ, dtype=jnp.float64)


def test_topology_tables_match():
    ref, port = RefTopology(N_, H), CubedSphereTopology(N_, H)
    assert ref.N == port.N
    for stagger in ("center", "corner"):
        _assert_spec_equal(ref.scalar_spec(stagger),
                           port.scalar_spec(stagger))
    for pair in (("y_iface", "x_iface"), ("x_iface", "y_iface"),
                 ("center", "center")):
        for a, b in zip(ref.vector_spec(*pair), port.vector_spec(*pair)):
            _assert_spec_equal(a, b)
        for a, b in zip(ref.interface_sync_map(*pair),
                        port.interface_sync_map(*pair)):
            _assert_spec_equal(a, b)
    for a, b in zip(ref.scalar_corner_specs(), port.scalar_corner_specs()):
        _assert_spec_equal(a, b)


def test_corner_tables_match():
    for d in ("x", "y"):
        for a, b in zip(ref_corners._copy_corners_table(N_, H, d),
                        corners._copy_corners_table(N_, H, d)):
            np.testing.assert_array_equal(a, b)
        for ncells in (2, 3):
            for a, b in zip(
                    ref_corners._fill_corners_cells_table(N_, H, d, ncells),
                    corners._fill_corners_cells_table(N_, H, d, ncells)):
                np.testing.assert_array_equal(a, b)
        for gridtype in ("A", "B"):
            for a, b in zip(
                    ref_corners._fill_corners_2d_table(N_, H, gridtype, d),
                    corners._fill_corners_2d_table(N_, H, gridtype, d)):
                np.testing.assert_array_equal(a, b)
    for grid in ("A", "C", "D"):
        ref = ref_corners._fill_corners_vector_tables(N_, H, grid)
        port = corners._fill_corners_vector_tables(N_, H, grid)
        for tgt in (0, 1):
            for a, b in zip(ref[tgt], port[tgt]):
                np.testing.assert_array_equal(a, b)


def test_grid_data_matches(ref_grid64):
    port = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float64)
    _assert_leaves_equal(_grid_leaves(ref_grid64), _grid_leaves(port))


def test_baroclinic_state_matches():
    ref = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    port = init_baroclinic_state(GridSizing(N_, NZ), device="cpu",
                                 dtype=torch.float64)
    _assert_leaves_equal(_state_leaves(ref), _state_leaves(port))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bridge_round_trip(ref_grid64, dtype):
    """Reference leaves -> numpy -> from_numpy equal the port's own init."""
    tdt = getattr(torch, dtype)
    ref_gd = ref_grid64 if dtype == "float64" else ref_grid(
        N_, NZ, dtype=jnp.float32)
    bridged = GridData.from_numpy(_grid_leaves(ref_gd), "cpu", tdt)
    own = generate_grid_data(N_, NZ, device="cpu", dtype=tdt)
    _assert_leaves_equal(_grid_leaves(bridged), _grid_leaves(own))
    assert bridged.dtype == own.dtype == tdt

    ref_state = ref_init(RefSizing(N_, NZ), dtype=getattr(jnp, dtype))
    bridged = DycoreState.from_numpy(_state_leaves(ref_state), "cpu", tdt)
    own = init_baroclinic_state(GridSizing(N_, NZ), device="cpu",
                                dtype=tdt)
    _assert_leaves_equal(_state_leaves(bridged), _state_leaves(own))


@pytest.mark.parametrize("entry", [generate_grid_data, init_baroclinic_state])
def test_entry_points_default_to_the_card(entry):
    """The grid and the initial state are built on the card unless the
    caller asks for the CPU (read from the signature; needs no card)."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
