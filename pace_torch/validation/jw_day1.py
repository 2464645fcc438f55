"""The JW day-1 anchor: one simulated day of the C12/79 float64
Jablonowski & Williamson baroclinic wave, digested to interior moments.

The same program and digest as the reference package's generator
(tests/golden/make_jw_day1.py:37-80): C12/79 float64, the default
dynamical-core settings with k_split=1, n_split=4, dt=450 s, 192 steps;
per field [mean, mean |.|, max |.|] over the compute interior, plus the
surface-pressure extrema in hPa.  `check` compares a digest with the
committed record (tests/golden/jw_day1_c12_f64.json) entry by entry.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

N, NZ, DT, STEPS = 12, 79, 450.0, 192
FIELDS = ("delp", "pt", "w", "delz", "qvapor", "u", "v", "ps")
RTOL = 1e-7


def digest(state, n: int = N, h: int = 3) -> Dict[str, List[float]]:
    """{field: [mean, mean |.|, max |.|]} over the compute interior, and
    "ps_minmax_hpa"."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).detach().cpu().numpy().astype(np.float64)
        v = a[:, h:h + n, h:h + n]
        out[name] = [float(v.mean()), float(np.abs(v).mean()),
                     float(np.abs(v).max())]
    ps = state.ps.detach().cpu().numpy()[:, h:h + n, h:h + n] / 100.0
    out["ps_minmax_hpa"] = [float(ps.min()), float(ps.max())]
    return out


def setup(device="cuda", dtype=torch.float64):
    """(dycore, initial state) of the anchor's program."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(N, NZ)
    gd = generate_grid_data(N, NZ, device=device, dtype=dtype)
    core = DynamicalCore(DynamicalCoreConfig(k_split=1, n_split=4), sizing,
                         gd, timestep=DT)
    return core, init_baroclinic_state(sizing, device=device, dtype=dtype)


def run_day1(device="cuda", dtype=torch.float64, steps: int = STEPS):
    """Run the anchor's `steps` steps (one simulated day by default) and
    return the digest of the final state."""
    core, state = setup(device, dtype)
    for _ in range(steps):
        state = core.step_dynamics(state)
    return digest(state)


def check(record: dict, got: dict,
          rtol: float = RTOL) -> Tuple[Dict[str, float], List[str]]:
    """(worst relative difference per entry of the record, the entries
    where it exceeds rtol).  The difference is |a - b| / max(|a|, |b|),
    as the reference's checker takes it."""
    worst, bad = {}, []
    for name, vals in record.items():
        rels = [abs(a - b) / max(abs(a), abs(b), 1e-30)
                for a, b in zip(vals, got[name])]
        worst[name] = max(rels)
        if not worst[name] <= rtol:
            bad.append(name)
    return worst, bad
