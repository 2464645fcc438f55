"""Prognostic/diagnostic state of the FV3 dynamical core, as torch tensors.

The same 32 fields, metadata and global padded layout (6, N, N[, nz]) as
`pace_tpu.models.fv3.state` (reference ai2cm/pace
fv3core/pace/fv3core/initialization/dycore_state.py:11).  Vertical sizes
are exact: nz for layer quantities, nz+1 for interface quantities.  A rank
of a multi-rank run holds its own tiles: a leading axis of 6 / t
(`from_numpy(..., scatter=...)`, parallel/partition.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from pace_torch.utils import constants

X = constants.X_DIM
XI = constants.X_INTERFACE_DIM
Y = constants.Y_DIM
YI = constants.Y_INTERFACE_DIM
Z = constants.Z_DIM
ZI = constants.Z_INTERFACE_DIM

# name -> (standard_name, dims, units)
FIELD_METADATA: Dict[str, tuple] = {
    "u": ("x_wind", (X, YI, Z), "m/s"),
    "v": ("y_wind", (XI, Y, Z), "m/s"),
    "w": ("vertical_wind", (X, Y, Z), "m/s"),
    "ua": ("eastward_wind", (X, Y, Z), "m/s"),
    "va": ("northward_wind", (X, Y, Z), "m/s"),
    "uc": ("x_wind_on_c_grid", (XI, Y, Z), "m/s"),
    "vc": ("y_wind_on_c_grid", (X, YI, Z), "m/s"),
    "delp": ("pressure_thickness_of_atmospheric_layer", (X, Y, Z), "Pa"),
    "delz": ("vertical_thickness_of_atmospheric_layer", (X, Y, Z), "m"),
    "ps": ("surface_pressure", (X, Y), "Pa"),
    "pe": ("interface_pressure", (X, Y, ZI), "Pa"),
    "pt": ("air_temperature", (X, Y, Z), "degK"),
    "peln": ("logarithm_of_interface_pressure", (X, Y, ZI), "ln(Pa)"),
    "pk": ("interface_pressure_raised_to_power_of_kappa", (X, Y, ZI),
           "unknown"),
    "pkz": ("layer_mean_pressure_raised_to_power_of_kappa", (X, Y, Z),
            "unknown"),
    "qvapor": ("specific_humidity", (X, Y, Z), "kg/kg"),
    "qliquid": ("cloud_water_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qice": ("cloud_ice_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qrain": ("rain_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qsnow": ("snow_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qgraupel": ("graupel_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qo3mr": ("ozone_mixing_ratio", (X, Y, Z), "kg/kg"),
    "qsgs_tke": ("turbulent_kinetic_energy", (X, Y, Z), "m**2/s**2"),
    "qcld": ("cloud_fraction", (X, Y, Z), ""),
    "q_con": ("total_condensate_mixing_ratio", (X, Y, Z), "kg/kg"),
    "omga": ("vertical_pressure_velocity", (X, Y, Z), "Pa/s"),
    "mfxd": ("accumulated_x_mass_flux", (XI, Y, Z), "unknown"),
    "mfyd": ("accumulated_y_mass_flux", (X, YI, Z), "unknown"),
    "cxd": ("accumulated_x_courant_number", (XI, Y, Z), "unknown"),
    "cyd": ("accumulated_y_courant_number", (X, YI, Z), "unknown"),
    "diss_estd": (
        "dissipation_estimate_from_heat_source", (X, Y, Z), "unknown"
    ),
    "phis": ("surface_geopotential", (X, Y), "m**2 s**-2"),
}

# the advected tracers, in the order the reference's tracer advection loops
# over them; NQ = 8 are advected, all 9 are remapped
TRACER_NAMES = (
    "qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel", "qo3mr",
    "qsgs_tke", "qcld",
)
NQ = 8


def zeros_numpy(sizing) -> Dict[str, np.ndarray]:
    """float64 zeros for every field, in the padded layout (6, N, N[, nz
    or nz + 1])."""
    arrays = {}
    for name, (_, dims, _) in FIELD_METADATA.items():
        shape = [6, sizing.N, sizing.N]
        if dims[-1] == Z:
            shape.append(sizing.nz)
        elif dims[-1] == ZI:
            shape.append(sizing.nz + 1)
        arrays[name] = np.zeros(tuple(shape))
    return arrays


@dataclasses.dataclass
class DycoreState:
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    uc: torch.Tensor
    vc: torch.Tensor
    delp: torch.Tensor
    delz: torch.Tensor
    ps: torch.Tensor
    pe: torch.Tensor
    pt: torch.Tensor
    peln: torch.Tensor
    pk: torch.Tensor
    pkz: torch.Tensor
    qvapor: torch.Tensor
    qliquid: torch.Tensor
    qice: torch.Tensor
    qrain: torch.Tensor
    qsnow: torch.Tensor
    qgraupel: torch.Tensor
    qo3mr: torch.Tensor
    qsgs_tke: torch.Tensor
    qcld: torch.Tensor
    q_con: torch.Tensor
    omga: torch.Tensor
    mfxd: torch.Tensor
    mfyd: torch.Tensor
    cxd: torch.Tensor
    cyd: torch.Tensor
    diss_estd: torch.Tensor
    phis: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays: dict, device, dtype,
                   scatter=None) -> "DycoreState":
        """Build from numpy arrays keyed by field name (the layout of
        `pace_tpu`'s DycoreState leaves), on `device` with `dtype`; with
        `scatter` (`Partition.scatterer(rank)`) one rank's part of them."""
        cut = scatter or (lambda a: a)
        return cls(**{
            name: torch.tensor(np.asarray(cut(arrays[name])), dtype=dtype,
                               device=device)
            for name in FIELD_METADATA
        })

    @property
    def device(self) -> torch.device:
        return self.u.device

    @property
    def dtype(self) -> torch.dtype:
        return self.u.dtype
