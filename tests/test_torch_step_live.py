"""One live C12/79 float64 step of the reference package (jitted JAX) and
of the port from the same numpy initial state, all 32 fields compared on
the compute domain at 1e-10 of each field's scale.  Slow tier: the JAX
side compiles and runs the whole step (~100 s on a CPU)."""

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


@pytest.mark.slow
def test_live_step_matches_reference():
    gd = ref_grid(N_, NZ, dtype=jnp.float64)
    state0 = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    ref_core = RefCore(RefConfig(do_sat_adj=False), RefSizing(N_, NZ), gd,
                       timestep=DT)
    ref = jax.jit(ref_core.step_dynamics)(state0)

    port_gd = GridData.from_numpy(_leaves(gd), "cpu", torch.float64)
    port_core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False),
                              GridSizing(N_, NZ), port_gd, timestep=DT)
    got = port_core.step_dynamics(
        DycoreState.from_numpy(_leaves(state0), "cpu", torch.float64))

    bad = {}
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))[:, H:H + N_, H:H + N_]
        g = getattr(got, f.name).numpy()[:, H:H + N_, H:H + N_]
        scale = float(np.abs(r).max()) + 1e-30
        err = float(np.abs(r - g).max()) / scale
        if not err <= 1e-10:
            bad[f.name] = err
    assert not bad, bad
