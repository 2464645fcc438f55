"""One live C12/79 float64 step of the reference package (jitted JAX) and
of the port from the same numpy initial state, all 32 fields compared on
the compute domain: at the default settings within 1e-10 of each field's
scale, at the dycore settings of examples/configs/c96_baroclinic_shield.yaml
and with each of the branches kord 8, do_skeb and the dynamic tracer
subcycle within 1e-9.  (kord 10 is held op by op in
tests/test_torch_branches.py: it branches on exact ties, where the two
packages' last-place differences pick different branches.)  Slow tier: the
JAX side compiles and runs the whole step (~100 s on a CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import generate_grid_data as ref_grid
from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefConfig
from pace_tpu.models.fv3.dynamics import DynamicalCore as RefCore
from pace_tpu.models.fv3.init.baroclinic import (
    init_baroclinic_state as ref_init,
)
from pace_tpu.utils.gridtools import GridSizing as RefSizing
from pace_torch.grid.generation import GridData
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.models.fv3.dynamics import DynamicalCore
from pace_torch.models.fv3.state import DycoreState
from pace_torch.utils.gridtools import GridSizing

N_, NZ, H, DT = 12, 79, 3, 225.0


def _leaves(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj) if hasattr(obj, "shape") else obj


def _live_step_errors(dt, tol, **settings):
    """Fields whose port-vs-reference error after one step exceeds tol."""
    gd = ref_grid(N_, NZ, dtype=jnp.float64)
    state0 = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    ref_core = RefCore(RefConfig(do_sat_adj=False, **settings),
                       RefSizing(N_, NZ), gd, timestep=dt)
    ref = jax.jit(ref_core.step_dynamics)(state0)

    port_gd = GridData.from_numpy(_leaves(gd), "cpu", torch.float64)
    port_core = DynamicalCore(
        DynamicalCoreConfig(do_sat_adj=False, **settings),
        GridSizing(N_, NZ), port_gd, timestep=dt)
    got = port_core.step_dynamics(
        DycoreState.from_numpy(_leaves(state0), "cpu", torch.float64))

    bad = {}
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))[:, H:H + N_, H:H + N_]
        g = getattr(got, f.name).numpy()[:, H:H + N_, H:H + N_]
        scale = float(np.abs(r).max()) + 1e-30
        err = float(np.abs(r - g).max()) / scale
        if not err <= tol:
            bad[f.name] = err
    return bad


@pytest.mark.slow
def test_live_step_matches_reference():
    bad = _live_step_errors(DT, 1e-10)
    assert not bad, bad


@pytest.mark.slow
def test_live_shield_step_matches_reference():
    """The dycore settings of examples/configs/c96_baroclinic_shield.yaml
    (hord 8, hord_tr 10, k_split 2, n_split 3, dt 300 s) at C12/79."""
    bad = _live_step_errors(
        300.0, 1e-9, k_split=2, n_split=3, hord_mt=8, hord_vt=8, hord_tm=8,
        hord_dp=8, hord_tr=10, rf_fast=True, tau=10.0, d_con=1.0,
        n_sponge=48)
    assert not bad, bad


@pytest.mark.slow
@pytest.mark.parametrize("settings", [
    dict(kord_mt=8, kord_wz=8, kord_tr=8, kord_tm=-8),
    dict(do_skeb=True),
    dict(dynamic_tracer_subcycle=True),
], ids=["kord8", "skeb", "subcycle"])
def test_live_branch_step_matches_reference(settings):
    bad = _live_step_errors(DT, 1e-9, **settings)
    assert not bad, bad
