"""The port's `QuantityFactory` (pace_torch.utils.quantity) against the
reference package's, for every kind of dimension: the same shapes,
origins, extents and values, and the same ValueError for an array of
neither the storage's nor the compute domain's shape."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pace_torch.utils import GridSizing, QuantityFactory, constants
from pace_tpu.utils import GridSizing as RefSizing
from pace_tpu.utils import QuantityFactory as RefFactory

N_, NZ = 6, 5
DIMS = [
    (constants.X_DIM, constants.Y_DIM),
    (constants.X_INTERFACE_DIM, constants.Y_DIM, constants.Z_DIM),
    (constants.X_DIM, constants.Y_INTERFACE_DIM, constants.Z_INTERFACE_DIM),
    (constants.TILE_DIM, constants.X_DIM, constants.Y_DIM, constants.Z_DIM),
    (constants.Z_DIM,),
]


@pytest.fixture(scope="module")
def factories():
    return (QuantityFactory(GridSizing(N_, NZ), torch.float64, device="cpu"),
            RefFactory(RefSizing(N_, NZ), jnp.float64))


def _assert_same(got, want):
    assert tuple(got.data.shape) == tuple(want.data.shape)
    assert (got.dims, got.units, got.origin, got.extent) == (
        want.dims, want.units, want.origin, want.extent)
    assert got.data.device.type == "cpu"
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.view.numpy(), np.asarray(want.view))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "-".join(d))
def test_factory_matches_reference(dims, factories):
    ours, theirs = factories
    for method in ("empty", "zeros", "ones"):
        _assert_same(getattr(ours, method)(dims, "m"),
                     getattr(theirs, method)(dims, "m"))
    storage = theirs.zeros(dims, "m")
    rng = np.random.default_rng(len(dims))
    for shape in (storage.data.shape, storage.extent):
        array = rng.standard_normal(shape)
        _assert_same(ours.from_array(array, dims, "K"),
                     theirs.from_array(array, dims, "K"))
    wrong = np.zeros(tuple(s + 1 for s in storage.extent))
    with pytest.raises(ValueError) as got:
        ours.from_array(wrong, dims, "K")
    with pytest.raises(ValueError) as want:
        theirs.from_array(wrong, dims, "K")
    assert str(got.value) == str(want.value)


def test_factory_defaults_to_the_card():
    assert QuantityFactory(GridSizing(N_, NZ)).device == "cuda"
    assert QuantityFactory(GridSizing(N_, NZ)).dtype == torch.float32
