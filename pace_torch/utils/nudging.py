"""Nudging toward a reference state.

Port of `pace_tpu.utils.nudging` (ai2cm/pace util/pace/util/nudging.py
apply_nudging, get_nudging_tendencies) on dicts of tensors: pure functions
that return new dicts and leave their arguments as they were.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Mapping


def _seconds(t) -> float:
    return t.total_seconds() if isinstance(t, timedelta) else float(t)


def get_nudging_tendencies(state: Mapping, reference_state: Mapping,
                           nudging_timescales: Mapping) -> dict:
    """Relaxation tendencies (reference - state) / timescale, per second,
    for each variable that has a timescale."""
    out = {}
    for name, timescale in nudging_timescales.items():
        if name not in state:
            raise ValueError(
                f"no state variable to apply tendency for {name}")
        out[name] = (reference_state[name] - state[name]) / _seconds(
            timescale)
    return out


def apply_nudging(state: Mapping, reference_state: Mapping,
                  nudging_timescales: Mapping, timestep):
    """Returns (nudged state, tendencies): state + tendency * timestep for
    each nudged variable, the others as they were."""
    tendencies = get_nudging_tendencies(state, reference_state,
                                        nudging_timescales)
    dt = _seconds(timestep)
    new_state = dict(state)
    for name, tendency in tendencies.items():
        new_state[name] = state[name] + tendency * dt
    return new_state, tendencies
