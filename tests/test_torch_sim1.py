"""The port's plain SIM1 solver (pace_torch.ops.riemann.sim1_solver_plain)
against the reference package's scan path (riemann.sim1_solver, which
float64 always takes) and its Pallas kernel in interpret mode, at nz 7 and
16 on the seeded inputs of tests/test_sim1_pallas.py.

Tolerance 1e-12 of each output's scale.  The recurrences are the same
float64 operations in the same order, but the reference's exp/log (XLA's)
and the port's (the C library's, as numpy's) differ by up to one ulp in
the equation-of-state pressure, and the tridiagonal solves amplify that:
measured 1.6e-13 in w at nz=7 (the reference's own scan and Pallas paths
agree to 4e-14), above the 1e-13 of test_sim1_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import riemann
from pace_tpu.ops.pallas import sim1_pallas
from pace_torch.ops import riemann as port_riemann
from pace_torch.testing import sim1_inputs

DT, P_FAC = 112.5, 0.05


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel_err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - np.asarray(got)).max()) / (
        float(np.abs(ref).max()) + 1e-30)


@pytest.mark.parametrize("nz", [7, 16])
def test_plain_sim1_matches_scan_and_pallas(nz):
    args = sim1_inputs(8, 8, nz)
    got = port_riemann.sim1_solver(
        *(torch.as_tensor(a) for a in args), DT, P_FAC)
    j = [jnp.asarray(a) for a in args]
    scan = riemann.sim1_solver(*j, DT, P_FAC)
    pallas = sim1_pallas.sim1_pallas(*j, DT, P_FAC, interpret=True)
    for name, g, s, p in zip(("w", "dz", "pe"), got, scan, pallas):
        assert g.shape == s.shape
        assert _rel_err(s, g.numpy()) < 1e-12, f"{name} vs scan"
        assert _rel_err(p, g.numpy()) < 1e-12, f"{name} vs pallas"


def test_plain_sim1_float32_accuracy():
    """At float32 the port's plain solver is as accurate, against the
    float64 truth, as the reference package's float32 scan path."""
    args = sim1_inputs(8, 8, 16)
    truth = riemann.sim1_solver(*(jnp.asarray(a) for a in args), DT, P_FAC)
    ref32 = riemann.sim1_solver(
        *(jnp.asarray(a, jnp.float32) for a in args), DT, P_FAC)
    got32 = port_riemann.sim1_solver(
        *(torch.as_tensor(a, dtype=torch.float32) for a in args), DT, P_FAC)
    for name, t, r, g in zip(("w", "dz", "pe"), truth, ref32, got32):
        err_ref = _rel_err(t, np.asarray(r, np.float64))
        err_got = _rel_err(t, g.double().numpy())
        assert err_got < 3.0 * err_ref + 1e-6, f"{name}: {err_got} {err_ref}"
