"""Quantity: a dims/units-aware container of a tensor, and the factory
that allocates them.

Port of `pace_tpu.utils.quantity.Quantity` and `QuantityFactory`
(reference ai2cm/pace util/pace/util/quantity.py:259 and
initialization/allocator.py:31): carries dimension names, units and the
compute-domain origin/extent alongside the raw tensor; `.view` returns the
compute-domain slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from pace_torch.utils import constants


@dataclasses.dataclass
class Quantity:
    data: torch.Tensor
    dims: Tuple[str, ...]
    units: str
    origin: Tuple[int, ...]
    extent: Tuple[int, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.origin) or len(self.dims) != len(self.extent):
            raise ValueError(
                f"dims/origin/extent length mismatch: {self.dims} {self.origin} "
                f"{self.extent}"
            )

    @property
    def metadata(self):
        return dict(dims=self.dims, units=self.units, origin=self.origin,
                    extent=self.extent, dtype=self.data.dtype)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def _slices(self):
        return tuple(slice(o, o + e) for o, e in zip(self.origin, self.extent))

    @property
    def view(self) -> torch.Tensor:
        """Compute-domain view of the data (a slice; `.with_view` returns
        a Quantity with new values there)."""
        return self.data[self._slices()]

    def with_data(self, data: torch.Tensor) -> "Quantity":
        return dataclasses.replace(self, data=data)

    def with_view(self, values: Any) -> "Quantity":
        data = self.data.clone()
        data[self._slices()] = torch.as_tensor(values, dtype=data.dtype,
                                               device=data.device)
        return self.with_data(data)

    def transpose(self, target_dims: Tuple[str, ...]) -> "Quantity":
        perm = tuple(self.dims.index(d) for d in target_dims)
        return Quantity(
            data=self.data.permute(perm),
            dims=tuple(self.dims[p] for p in perm),
            units=self.units,
            origin=tuple(self.origin[p] for p in perm),
            extent=tuple(self.extent[p] for p in perm),
        )

    def __repr__(self):
        return (
            f"Quantity(dims={self.dims}, units={self.units!r}, "
            f"origin={self.origin}, extent={self.extent}, "
            f"shape={tuple(self.data.shape)})"
        )


def _dim_sizes(sizing, dims):
    """Map dim names -> (array size, origin, extent) for the global layout."""
    out_shape, origin, extent = [], [], []
    for d in dims:
        if d == constants.TILE_DIM:
            size, start, count = constants.N_TILES, 0, constants.N_TILES
        elif d in (constants.X_DIM, constants.Y_DIM):
            size, start, count = sizing.N, sizing.halo, sizing.n
        elif d in (constants.X_INTERFACE_DIM, constants.Y_INTERFACE_DIM):
            size, start, count = sizing.N, sizing.halo, sizing.n + 1
        elif d == constants.Z_DIM:
            size, start, count = sizing.nz, 0, sizing.nz
        elif d == constants.Z_INTERFACE_DIM:
            size, start, count = sizing.nz + 1, 0, sizing.nz + 1
        else:
            raise ValueError(f"unknown dimension name {d!r}")
        out_shape.append(size)
        origin.append(start)
        extent.append(count)
    return tuple(out_shape), tuple(origin), tuple(extent)


@dataclasses.dataclass(frozen=True)
class QuantityFactory:
    """Allocates Quantities with the global (tile, x, y, z) layout on
    `device`.

    Analogue of ai2cm/pace util/pace/util/initialization/allocator.py:31.
    """

    sizing: Any  # GridSizing
    dtype: Any = torch.float32
    device: Any = "cuda"

    def _quantity(self, data, dims, units, origin, extent):
        return Quantity(data=data, dims=tuple(dims), units=units,
                        origin=origin, extent=extent)

    def empty(self, dims, units, dtype=None):
        return self.zeros(dims, units, dtype)

    def zeros(self, dims, units, dtype=None):
        shape, origin, extent = _dim_sizes(self.sizing, dims)
        return self._quantity(
            torch.zeros(shape, dtype=dtype or self.dtype,
                        device=self.device), dims, units, origin, extent)

    def ones(self, dims, units, dtype=None):
        shape, origin, extent = _dim_sizes(self.sizing, dims)
        return self._quantity(
            torch.ones(shape, dtype=dtype or self.dtype, device=self.device),
            dims, units, origin, extent)

    def from_array(self, array, dims, units):
        """Wrap a storage-sized or compute-domain-sized array, padding
        halos with zeros."""
        shape, origin, extent = _dim_sizes(self.sizing, dims)
        array = np.asarray(array)
        if tuple(array.shape) == tuple(shape):
            full = array
        elif tuple(array.shape) == tuple(extent):
            full = np.zeros(shape, dtype=array.dtype)
            full[tuple(slice(o, o + e) for o, e in zip(origin, extent))] = (
                array)
        else:
            raise ValueError(
                f"array shape {array.shape} matches neither storage {shape} "
                f"nor compute extent {extent} for dims {dims}"
            )
        return self._quantity(
            torch.as_tensor(full, dtype=self.dtype, device=self.device),
            dims, units, origin, extent)
