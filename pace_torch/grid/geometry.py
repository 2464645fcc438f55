"""Spherical-geometry helpers for grid metric generation (numpy, init-time).

Re-derived from the geometric definitions used by FV3 / the reference
implementation (ai2cm/pace util/pace/util/grid/gnomonic.py:343-734 and
geometry.py) — great-circle distances, spherical excess areas, spherical
angles between grid lines.
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def lonlat_to_xyz(lon, lat):
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        axis=-1,
    )


def xyz_to_lonlat(xyz):
    norm = np.sqrt((xyz ** 2).sum(axis=-1, keepdims=True))
    xyz = xyz / norm
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.where(np.abs(x) + np.abs(y) < 1e-10, 0.0, np.arctan2(y, x))
    lon = np.where(lon < 0.0, lon + 2 * PI, lon)
    lat = np.arcsin(np.clip(z, -1, 1))
    return lon, lat


def normalize_xyz(xyz):
    # zero vectors (padding cells) normalize to NaN; callers nan_to_num
    with np.errstate(invalid="ignore", divide="ignore"):
        return xyz / np.sqrt((xyz ** 2).sum(axis=-1, keepdims=True))


def xyz_midpoint(*points):
    return normalize_xyz(sum(points))


def lon_lat_midpoint(lon1, lon2, lat1, lat2):
    p1 = lonlat_to_xyz(lon1, lat1)
    p2 = lonlat_to_xyz(lon2, lat2)
    return xyz_to_lonlat(xyz_midpoint(p1, p2))


def great_circle_distance_lon_lat(lon1, lon2, lat1, lat2, radius):
    beta = 2.0 * np.arcsin(
        np.sqrt(
            np.sin((lat1 - lat2) / 2.0) ** 2
            + np.cos(lat1) * np.cos(lat2) * np.sin((lon1 - lon2) / 2.0) ** 2
        )
    )
    return radius * beta


def great_circle_distance_xyz(p1, p2, radius):
    lon1, lat1 = xyz_to_lonlat(p1)
    lon2, lat2 = xyz_to_lonlat(p2)
    return great_circle_distance_lon_lat(lon1, lon2, lat1, lat2, radius)


def spherical_angle(p_center, p2, p3):
    """Angle at p_center between great circles to p2 and to p3 (< pi)."""
    p = np.cross(p_center, p2)
    q = np.cross(p_center, p3)
    denom = np.sqrt((p ** 2).sum(-1) * (q ** 2).sum(-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        angle = np.arccos(np.clip((p * q).sum(-1) / denom, -1.0, 1.0))
    return np.where(np.isnan(angle), 0.0, angle)


def spherical_cos(p_center, p2, p3):
    p = np.cross(p_center, p2)
    q = np.cross(p_center, p3)
    denom = np.sqrt((p ** 2).sum(-1) * (q ** 2).sum(-1))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = (p * q).sum(-1) / denom
    return out


def get_rectangle_area(p1, p2, p3, p4, radius):
    """Spherical-excess area of the quadrilateral p1-p2-p3-p4 (corners given
    in cyclic order along the boundary)."""
    total = spherical_angle(p2, p3, p1)
    for q1, q2, q3 in ((p3, p2, p4), (p4, p3, p1), (p1, p4, p2)):
        total = total + spherical_angle(q1, q2, q3)
    return (total - 2 * PI) * radius ** 2


def get_triangle_area(p1, p2, p3, radius):
    total = spherical_angle(p1, p2, p3)
    for q1, q2, q3 in ((p2, p3, p1), (p3, p1, p2)):
        total = total + spherical_angle(q1, q2, q3)
    return (total - PI) * radius ** 2


def cell_area_from_corners(corner_xyz, radius):
    """Cell areas from a corner-point array [..., ni, nj, 3]: spherical
    quadrilateral area of each cell."""
    ll = corner_xyz[..., :-1, :-1, :]
    lr = corner_xyz[..., 1:, :-1, :]
    ul = corner_xyz[..., :-1, 1:, :]
    ur = corner_xyz[..., 1:, 1:, :]
    return get_rectangle_area(ll, ul, ur, lr, radius)


def get_unit_vector_direction(p1_lonlat, p2_lonlat):
    """Unit vector pointing from lon/lat points p1 to p2 ([..., 2] arrays)."""
    xyz1 = lonlat_to_xyz(p1_lonlat[..., 0], p1_lonlat[..., 1])
    xyz2 = lonlat_to_xyz(p2_lonlat[..., 0], p2_lonlat[..., 1])
    midpoint = xyz_midpoint(xyz1, xyz2)
    p3 = np.cross(xyz2, xyz1)
    return normalize_xyz(np.cross(midpoint, p3))


def lonlat_unit_vectors(lon, lat):
    """Eastward and northward unit vectors at given lon/lat points."""
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    unit_lon = np.stack([-sin_lon, cos_lon, np.zeros_like(lon)], axis=-1)
    unit_lat = np.stack(
        [-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat], axis=-1
    )
    return unit_lon, unit_lat
