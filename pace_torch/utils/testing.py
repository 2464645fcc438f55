"""Numerical comparison and perturbation helpers.

The port's own copy of `pace_tpu.utils.testing` (ai2cm/pace
util/pace/util/testing/comparison.py:6-59, perturbation.py:6): the
relative error metric with a near-zero floor that the savepoint harness
(`pace_torch.utils.translate`) validates with.  Everything works on numpy
arrays; tensors on any device are accepted and copied to the host first.

Not to be confused with `pace_torch.testing`, which builds the seeded
inputs that hold each kernel and module against its reference.
"""

from __future__ import annotations

import numpy as np

from pace_torch.utils.host import as_numpy


def compare_arr(computed_data, ref_data):
    """Smooth error metric: 2 |a - b| / (|a| + |b|), 0 where both are 0;
    for booleans, where they differ."""
    computed_data, ref_data = as_numpy(computed_data), as_numpy(ref_data)
    if ref_data.dtype in (np.float64, np.int64, np.float32, np.int32):
        denom = np.abs(ref_data) + np.abs(computed_data)
        compare = np.asarray(2.0 * np.abs(computed_data - ref_data) / denom)
        compare[denom == 0] = 0.0
        return compare
    if ref_data.dtype in (np.bool_, bool):
        return np.logical_xor(computed_data, ref_data)
    raise TypeError(f"received data with unexpected dtype {ref_data.dtype}")


def compare_scalar(computed_data, ref_data) -> np.float64:
    return compare_arr(np.atleast_1d(as_numpy(computed_data)),
                       np.atleast_1d(as_numpy(ref_data)))[0]


def success_array(computed_data, ref_data, eps: float,
                  ignore_near_zero_errors: bool, near_zero: float):
    """Where computed and reference agree: bit-identical values (the
    relative metric is NaN for a pair of equal infinities), NaN at both,
    a metric below eps, or, with ignore_near_zero_errors, both below
    near_zero in magnitude."""
    computed_data, ref_data = as_numpy(computed_data), as_numpy(ref_data)
    with np.errstate(invalid="ignore"):
        exact_equal = computed_data == ref_data
    success = np.logical_or(
        np.logical_or(
            exact_equal,
            np.logical_and(np.isnan(computed_data), np.isnan(ref_data)),
        ),
        compare_arr(computed_data, ref_data) < eps,
    )
    if ignore_near_zero_errors:
        success = np.logical_or(
            success,
            np.logical_and(np.abs(computed_data) < near_zero,
                           np.abs(ref_data) < near_zero),
        )
    return success


def perturb(state: dict, scale: float = 1e-14, seed: int = 0) -> dict:
    """A copy of a dict of arrays with multiplicative noise of relative
    size `scale` on its floating arrays (for threshold calibration)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, arr in state.items():
        arr = as_numpy(arr)
        if np.issubdtype(arr.dtype, np.floating):
            roundoff = scale * np.abs(arr)
            out[name] = arr + roundoff * (
                2.0 * rng.uniform(size=arr.shape) - 1.0)
        else:
            out[name] = arr.copy()
    return out
