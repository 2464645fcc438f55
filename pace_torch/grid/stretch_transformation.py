"""Schmidt stretched-grid transformation.

The port's own copy of `pace_tpu.grid.stretch_transformation` (reference
ai2cm/pace util/pace/util/grid/stretch_transformation.py
`direct_transform`, fv_grid_utils.F90 direct_transform): shrinks tile 6 in
area by `stretch_factor` to concentrate resolution, then rotates the cube
so the refined tile is centered on (lon_target, lat_target).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# added to all longitudes to match the SHiELD stretched TC configuration:
# 180 flips the orientation about the center tile, 10 accounts for the
# tile-center offset from the prime meridian
STRETCH_GRID_ROTATION_LON_OFFSET_DEG = 190.0


def direct_transform(
    *, lon: np.ndarray, lat: np.ndarray, stretch_factor: float,
    lon_target: float, lat_target: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """lon/lat in radians; targets in degrees.  Returns transformed
    (lon, lat) in radians, same shapes."""
    lon = np.asarray(lon, np.float64).copy()
    lat = np.asarray(lat, np.float64)

    lon = lon + np.deg2rad(STRETCH_GRID_ROTATION_LON_OFFSET_DEG)
    lon = np.mod(lon, 2.0 * np.pi)

    lon_p = np.deg2rad(lon_target)
    lat_p = np.deg2rad(lat_target)
    sin_p, cos_p = np.sin(lat_p), np.cos(lat_p)
    c2p1 = 1.0 + stretch_factor ** 2
    c2m1 = 1.0 - stretch_factor ** 2

    if abs(c2m1) > 1e-7:
        lat_t = np.arcsin(
            (c2m1 + c2p1 * np.sin(lat)) / (c2p1 + c2m1 * np.sin(lat))
        )
    else:
        lat_t = lat

    sin_o = -(sin_p * np.sin(lat_t) + cos_p * np.cos(lat_t) * np.cos(lon))
    near_pole = (1.0 - np.abs(sin_o)) < 1e-7

    lon_out = np.where(
        near_pole,
        0.0,
        lon_p + np.arctan2(
            -np.cos(lat_t) * np.sin(lon),
            -np.sin(lat_t) * cos_p + np.cos(lat_t) * sin_p * np.cos(lon),
        ),
    )
    lat_out = np.where(
        near_pole, 0.5 * np.pi * np.sign(sin_o), np.arcsin(sin_o)
    )
    lon_out = np.mod(lon_out, 2.0 * np.pi)
    return lon_out, lat_out
