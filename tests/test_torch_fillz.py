"""The port's plain fillz (pace_torch.ops.fillz.fix_tracers, the scan form
per tracer) against the reference package's scan path (fillz.fix_tracer,
which float64 always takes) and its Pallas kernel in interpret mode, on a
stack of 4 seeded tracers with negatives (tests/test_fillz_pallas.py).

Tolerance 1e-13 of the output scale, the bar of test_fillz_pallas.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import fillz
from pace_tpu.ops.pallas import fillz_pallas
from pace_torch.ops import fillz as port_fillz
from pace_torch.testing import fillz_inputs


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
