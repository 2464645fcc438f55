"""Selective-validation helpers.

Port of `pace_tpu.utils.functional_validation` (ai2cm/pace
fv3core/pace/fv3core/utils/functional_validation.py get_subset_func,
get_set_nan_func, and testing/validation.py get_selective_class): restrict
a comparison to the region a computation validates (the compute domain
plus a chosen halo depth) on the global (6, N, N, ...) layout.  Each
function takes a numpy array or a tensor and returns the same kind, a
tensor on its own device.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from pace_torch.utils.host import as_numpy


def _window(sizing, dims, n_halo):
    """(i0, i1, j0, j1) of the validated window: the compute domain (+1 on
    interface axes) extended by n_halo points on each side."""
    h, n = sizing.halo, sizing.n
    ni = n + (1 if "x_interface" in dims[0] else 0)
    nj = n + (1 if len(dims) > 1 and "y_interface" in dims[1] else 0)
    return (h - n_halo[0][0], h + ni + n_halo[0][1],
            h - n_halo[1][0], h + nj + n_halo[1][1])


def get_subset_func(
    sizing,
    dims: Sequence[str] = ("x", "y", "z"),
    n_halo: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
) -> Callable:
    """subset(data): the validated window of a global-view array."""
    i0, i1, j0, j1 = _window(sizing, dims, n_halo)

    def subset(data):
        return data[:, i0:i1, j0:j1]

    return subset


def get_set_nan_func(sizing, dims=("x", "y", "z"),
                     n_halo=((0, 0), (0, 0))) -> Callable:
    """set_nans(data): a new array, of the float dtype of `data` (float64
    for a numpy array, as the reference), with everything outside the
    validated window NaN."""
    i0, i1, j0, j1 = _window(sizing, dims, n_halo)
    idx = np.arange(sizing.N)
    keep = (((idx >= i0) & (idx < i1))[:, None]
            & ((idx >= j0) & (idx < j1))[None, :])

    def set_nans(data):
        shape = (1,) + keep.shape + (1,) * (data.ndim - 3)
        if isinstance(data, torch.Tensor):
            mask = torch.as_tensor(keep.reshape(shape), device=data.device)
            out = data if data.is_floating_point() else data.double()
            return torch.where(mask, out, torch.nan)
        data = np.array(data, dtype=float, copy=True)
        return np.where(keep.reshape(shape), data, np.nan)

    return set_nans


def selective_compare(a, b, sizing, dims=("x", "y", "z"),
                      n_halo=((0, 0), (0, 0)), rtol=1e-12, atol=0.0):
    """Assert two global-view arrays or tensors agree over the validated
    window only."""
    subset = get_subset_func(sizing, dims, n_halo)
    np.testing.assert_allclose(as_numpy(subset(a)), as_numpy(subset(b)),
                               rtol=rtol, atol=atol)
