"""Hybrid sigma-pressure vertical coordinate: p(k) = ak(k) + bk(k) * p_surface.

The ak/bk coefficient tables for the 79- and 91-level FV3GFS configurations
are physical configuration data shared with the Fortran model (reference:
ai2cm/pace util/pace/util/grid/eta.py:24 `set_hybrid_pressure_coefficients`);
they are stored here as binary data in
``data/hybrid_pressure_coefficients.npz``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_DATA_PATH = os.path.join(
    os.path.dirname(__file__), "data", "hybrid_pressure_coefficients.npz"
)


@dataclasses.dataclass(frozen=True)
class HybridPressureCoefficients:
    ks: int
    ptop: float
    ak: np.ndarray
    bk: np.ndarray


def set_hybrid_pressure_coefficients(
    km: int, eta_file: str = None
) -> HybridPressureCoefficients:
    """Return the ak/bk tables (length km+1) for a supported level count.

    ks is the number of pure-pressure layers at the model top (bk == 0);
    ptop is the pressure at the model top interface, ak[0].

    Args:
        km: number of vertical levels.
        eta_file: optional path to a file holding "ak" and "bk" variables
            of length km+1 — NetCDF3 (the reference's eta-file format,
            driver/pace/driver/grid.py:82 GeneratedGridConfig) or npz.
            Overrides the built-in 79/91-level tables.
    """
    if eta_file is not None:
        if eta_file.endswith(".npz"):
            src = np.load(eta_file)
        else:
            from pace_torch.utils.netcdf import read_dataset

            src = read_dataset(eta_file)
        ak = np.asarray(src["ak"], np.float64)
        bk = np.asarray(src["bk"], np.float64)
        if ak.shape != (km + 1,) or bk.shape != (km + 1,):
            raise ValueError(
                f"eta file {eta_file}: ak/bk must have length km+1="
                f"{km + 1}, got {ak.shape}/{bk.shape}"
            )
    else:
        data = np.load(_DATA_PATH)
        try:
            ak = data[f"ak_{km}"].astype(np.float64)
            bk = data[f"bk_{km}"].astype(np.float64)
        except KeyError:
            raise NotImplementedError(
                f"no hybrid pressure coefficients for km={km}; supported: "
                "79, 91 (or provide eta_file)"
            )
    if 0.0 in bk:
        ks = int(np.where(bk == 0)[0][-1])
    else:
        raise ValueError("bk must contain at least one 0.0")
    ptop = float(ak[0])
    return HybridPressureCoefficients(ks=ks, ptop=ptop, ak=ak, bk=bk)
