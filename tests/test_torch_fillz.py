"""The port's plain fillz (pace_torch.ops.fillz.fix_tracers, the scan form
per tracer) against the reference package's scan path (fillz.fix_tracer,
which float64 always takes) and its Pallas kernel in interpret mode, on a
stack of 4 seeded tracers with negatives (tests/test_fillz_pallas.py), and
against the scan path at the main path's depth (9 tracers, 79 levels).

Tolerance 1e-13 of the output scale, the bar of test_fillz_pallas.py.

Also what the CUDA kernel's shortcut for columns without negatives rests
on: where such a column holds a zero or non-finite dp, or a NaN q, the
output is non-finite exactly where the reference's is; and the CUDA
wrapper's contract, with the launch recorded instead of made."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import fillz
from pace_tpu.ops.pallas import fillz_pallas
from pace_torch.ops import fillz as port_fillz
from pace_torch.testing import fillz_inputs, plant_fillz_hazards


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("nz", [7, 16])
def test_plain_fillz_matches_scan_and_pallas(nz):
    q, dp = fillz_inputs(4, 8, 8, nz)
    got = port_fillz.fix_tracers(torch.as_tensor(q), torch.as_tensor(dp))
    got = got.numpy()
    qj, dpj = jnp.asarray(q), jnp.asarray(dp)
    scan = np.asarray(jax.vmap(lambda t: fillz.fix_tracer(t, dpj))(qj))
    pallas = np.asarray(jax.vmap(
        lambda t: fillz_pallas.fix_tracer_pallas(t, dpj, interpret=True))(qj))
    scale = float(np.abs(scan).max()) + 1e-30
    assert float(np.abs(scan - got).max()) / scale < 1e-13
    assert float(np.abs(pallas - got).max()) / scale < 1e-13
    # levels 1.. are left non-negative exactly where the reference leaves them
    assert ((got[..., 1:] >= -1e-12).all()
            == (scan[..., 1:] >= -1e-12).all())


def test_plain_fillz_level0_passthrough_and_clean_columns():
    """Level 0 is only clipped at zero; a column without negatives is left
    exactly as it was."""
    q, dp = fillz_inputs(2, 4, 4, 9, neg_frac=0.0)
    q[0, 0, 0, 0, 0] = -0.25
    got = port_fillz.fix_tracers(torch.as_tensor(q), torch.as_tensor(dp))
    got = got.numpy()
    assert got[0, 0, 0, 0, 0] == 0.0
    np.testing.assert_array_equal(got[1], q[1])


def _scan(q, dp):
    dpj = jnp.asarray(dp)
    return np.asarray(jax.vmap(lambda t: fillz.fix_tracer(t, dpj))(
        jnp.asarray(q)))


@pytest.mark.parametrize("neg_frac", [0.3, 1e-2])
def test_plain_fillz_matches_scan_at_main_path_depth(neg_frac):
    q, dp = fillz_inputs(9, 4, 4, 79, neg_frac=neg_frac)
    got = port_fillz.fix_tracers(torch.as_tensor(q), torch.as_tensor(dp))
    scan = _scan(q, dp)
    scale = float(np.abs(scan).max()) + 1e-30
    assert float(np.abs(scan - got.numpy()).max()) / scale < 1e-13


@pytest.mark.parametrize("field,value", [("dp", 0.0), ("dp", np.inf),
                                         ("dp", np.nan), ("q", np.nan)])
def test_plain_fillz_clean_column_hazard_matches_reference(field, value):
    """A column without negatives is not always a copy: a zero or
    non-finite dp, or a NaN q, gives non-finite values exactly where the
    reference gives them, and the same values elsewhere."""
    q, dp = fillz_inputs(2, 4, 4, 9, neg_frac=0.0)
    (dp if field == "dp" else q[1])[2, 1, 3, 4] = value
    got = port_fillz.fix_tracers(torch.as_tensor(q),
                                 torch.as_tensor(dp)).numpy()
    scan = _scan(q, dp)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(scan))
    # an infinite dp alone divides the zero borrows to zero
    assert np.isfinite(got[1, 2, 1, 3]).all() == (value == np.inf)
    fin = np.isfinite(scan)
    np.testing.assert_allclose(got[fin], scan[fin], rtol=1e-13, atol=0)
    # every other column is the copy
    other = np.ones(q.shape[:-1], bool)
    other[:, 2, 1, 3] = False
    np.testing.assert_array_equal(got[other], q[other])


def test_plain_fillz_planted_hazards_match_reference():
    """The inputs of the card's hazard check (pace_torch.testing.
    plant_fillz_hazards), at a small size, against the reference."""
    q, dp = plant_fillz_hazards(*fillz_inputs(2, 4, 4, 9, neg_frac=0.02))
    got = port_fillz.fix_tracers(torch.as_tensor(q),
                                 torch.as_tensor(dp)).numpy()
    scan = _scan(q, dp)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(scan))
    fin = np.isfinite(scan)
    assert (~fin).any() and fin.any()
    scale = float(np.abs(scan[fin]).max())
    assert float(np.abs(got[fin] - scan[fin]).max()) / scale < 1e-13


@pytest.fixture
def recorded_launches(monkeypatch):
    """The CUDA wrapper with the launch recorded instead of made (no card
    here); CPU tensors pass for CUDA ones."""
    from pace_torch.ops import _cuda

    launched = []
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dtype, *t, ints=(): launched.append(
                            (name, dtype, len(t), ints)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(port_fillz, "LAUNCHES", 0)
    return launched


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_wrapper_launches_once(recorded_launches, dtype):
    q, dp = (torch.as_tensor(a, dtype=dtype)
             for a in fillz_inputs(9, 3, 5, 79))
    out = port_fillz.fix_tracers(q, dp)
    assert out.shape == q.shape and out.dtype == dtype
    assert recorded_launches == [("fillz", dtype, 3, (9, 6 * 3 * 5, 79))]
    assert port_fillz.LAUNCHES == 1


@pytest.mark.parametrize("case", ["nz < 3", "dp shape", "dp dtype",
                                  "q not contiguous"])
def test_kernel_wrapper_refuses_before_launch(recorded_launches, case):
    q, dp = (torch.as_tensor(a) for a in fillz_inputs(2, 3, 5, 8))
    if case == "nz < 3":
        q, dp = q[..., :2].contiguous(), dp[..., :2].contiguous()
    elif case == "dp shape":
        dp = dp[:, 1:].contiguous()
    elif case == "dp dtype":
        dp = dp.float()
    else:
        q = q.transpose(2, 3)
        dp = dp.transpose(1, 2).contiguous()
    with pytest.raises((ValueError, TypeError)):
        port_fillz.fix_tracers_cuda(q, dp)
    assert recorded_launches == [] and port_fillz.LAUNCHES == 0
