"""Quantity: a dims/units-aware container of a tensor.

Port of `pace_tpu.utils.quantity.Quantity` (reference ai2cm/pace
util/pace/util/quantity.py:259): carries dimension names, units and the
compute-domain origin/extent alongside the raw tensor; `.view` returns the
compute-domain slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


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
