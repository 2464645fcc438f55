"""Equal-edge-distance gnomonic cubed-sphere grid construction.

Builds the cell-corner coordinates of all six cube faces with the same
conventions as FV3 / the reference implementation (ai2cm/pace
util/pace/util/grid/gnomonic.py:26 `local_gnomonic_ed` and grid/mirror.py
`mirror_grid`), re-derived as vectorized numpy:

* Tile 1 lies on the cube face x = -1/sqrt(3) (sphere of unit radius,
  inscribed cube).  Its west edge (lon = 3*pi/4) has corner points equally
  spaced in latitude between -alpha and +alpha, alpha = asin(1/sqrt(3)).
  The south edge follows by mirror symmetry about the face diagonal; interior
  points are the tensor product of the edge projections in cube-face
  coordinates.  Longitudes are then shifted by -pi so tile 1 is centered on
  lon = 0.
* Tiles 2..6 are exact 90-degree rotations of tile 1, applied in the
  left-handed Cartesian frame (z = -sin(lat)) used by FV3:
    tile2 = Rz(-90); tile3 = Rx(+90)Rz(-90); tile4 = Rx(+90)Rz(180);
    tile5 = Ry(+90)Rz(+90); tile6 = Ry(+90).
  Rotations use exact integer matrices so shared tile edges coincide to
  machine precision.

This module is init-time-only (numpy, float64); nothing here is jitted.
"""

from __future__ import annotations

import functools

import numpy as np

PI = np.pi
ALPHA = np.arcsin(3.0 ** -0.5)


def lonlat_to_xyz(lon, lat):
    """Right-handed unit-sphere Cartesian coordinates."""
    lon, lat = np.asarray(lon), np.asarray(lat)
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        axis=-1,
    )


def xyz_to_lonlat(xyz):
    xyz = np.asarray(xyz)
    norm = np.sqrt((xyz ** 2).sum(axis=-1))
    x, y, z = xyz[..., 0] / norm, xyz[..., 1] / norm, xyz[..., 2] / norm
    lon = np.where(np.abs(x) + np.abs(y) < 1e-10, 0.0, np.arctan2(y, x))
    lon = np.where(lon < 0.0, lon + 2.0 * PI, lon)
    lat = np.arcsin(np.clip(z, -1.0, 1.0))
    return lon, lat


def _mirror_across_diagonal(p, p1, p2):
    """Reflect points p across the great circle through p1, p2 (all xyz)."""
    nb = np.cross(p1, p2)
    nb = nb / np.sqrt((nb ** 2).sum())
    pdot = (p * nb).sum(axis=-1, keepdims=True)
    return p - 2.0 * pdot * nb


def tile1_corners(n: int) -> np.ndarray:
    """Corner xyz of tile 1, shape (n+1, n+1, 3), right-handed frame,
    longitudes already shifted so the face is centered on lon=0."""
    dely = 2.0 * ALPHA / n
    lon_w, lon_e = 0.75 * PI, 1.25 * PI
    lat_s, lat_n = -ALPHA, ALPHA

    j = np.arange(n + 1)
    # west edge: equally spaced latitudes along the lon=3pi/4 meridian
    west_lat = -ALPHA + dely * j
    west_xyz = lonlat_to_xyz(np.full(n + 1, lon_w), west_lat)
    # south edge: mirror of the west-edge points across the face diagonal
    p1 = lonlat_to_xyz(lon_w, lat_s)
    p2 = lonlat_to_xyz(lon_e, lat_n)
    south_xyz = _mirror_across_diagonal(west_xyz, p1, p2)

    # project both edges onto the cube face x = -1/sqrt(3)
    c = 3.0 ** -0.5

    def to_face(p):
        scale = -c / p[..., 0]
        return p * scale[..., None]

    west_f = to_face(west_xyz)    # gives exact z coordinates along j
    south_f = to_face(south_xyz)  # gives exact y coordinates along i

    pp = np.empty((n + 1, n + 1, 3))
    pp[..., 0] = -c
    pp[..., 1] = south_f[:, 1][:, None]  # y varies with i
    pp[..., 2] = west_f[:, 2][None, :]   # z varies with j

    # exact corner points
    pp[0, 0] = lonlat_to_xyz(lon_w, lat_s)
    pp[n, 0] = lonlat_to_xyz(lon_e, lat_s)
    pp[0, n] = lonlat_to_xyz(lon_w, lat_n)
    pp[n, n] = lonlat_to_xyz(lon_e, lat_n)

    pp = pp / np.sqrt((pp ** 2).sum(axis=-1, keepdims=True))

    lon, lat = xyz_to_lonlat(pp)
    lon = lon - PI  # center tile 1 on lon=0

    # four-fold symmetrization (reference mirror.py:38-68): average the
    # magnitudes of the four symmetric images, keep the local sign
    def symmetrize(a):
        mags = 0.25 * (
            np.abs(a) + np.abs(a[::-1, :]) + np.abs(a[:, ::-1])
            + np.abs(a[::-1, ::-1])
        )
        return np.copysign(mags, a)

    lon = symmetrize(lon)
    lat = symmetrize(lat)
    if (n + 1) % 2 == 1:
        lon[n // 2, :] = 0.0  # center meridian is exactly Greenwich-offset

    return lonlat_to_xyz(lon, lat)


# exact 90-degree rotation matrices in the left-handed frame, matching
# reference mirror.py:_rot_3d (axis=1: x, axis=2: y, axis=3: z)
def _rx(q):  # q quarter-turns
    c, s = _cs(q)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _ry(q):
    c, s = _cs(q)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _rz(q):
    c, s = _cs(q)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _cs(quarter_turns):
    table = {0: (1, 0), 1: (0, 1), 2: (-1, 0), 3: (0, -1)}
    return table[quarter_turns % 4]


# per-tile rotation (left-handed frame), tiles indexed 0..5
_TILE_ROTATIONS = [
    np.eye(3, dtype=int),
    _rz(-1),            # tile 2: Rz(-90)
    _rx(1) @ _rz(-1),   # tile 3: Rz(-90) then Rx(+90)  (north-pole tile)
    _rx(1) @ _rz(2),    # tile 4: Rz(180) then Rx(+90)
    _ry(1) @ _rz(1),    # tile 5: Rz(+90) then Ry(+90)
    _ry(1),             # tile 6: Ry(+90)               (south-pole tile)
]


def _to_left_handed(xyz):
    out = xyz.copy()
    out[..., 2] = -out[..., 2]
    return out


def _every_corner(n: int):
    return np.meshgrid(np.arange(6), np.arange(n + 1), np.arange(n + 1),
                       indexing="ij")


def cube_corners(n: int) -> np.ndarray:
    """Corner xyz for all 6 tiles, shape (6, n+1, n+1, 3), right-handed frame.
    """
    return corner_xyz_at(n, *_every_corner(n))


def cube_corners_lonlat(n: int):
    """(lon, lat) corner arrays, each shape (6, n+1, n+1)."""
    return corner_lonlat_at(n, *_every_corner(n))


@functools.lru_cache(maxsize=2)
def _tile1_left_handed(n: int) -> np.ndarray:
    return _to_left_handed(tile1_corners(n))


def corner_xyz_at(n: int, t, a, b) -> np.ndarray:
    """Corner xyz (right-handed frame) of the corners (t, a, b) (int
    arrays of one shape) alone: tile 1's corners there, rotated to tile t
    (exactly: the rotations are signed permutations)."""
    t, a, b = np.broadcast_arrays(t, a, b)
    base = _tile1_left_handed(n)[a, b]
    out = np.empty(base.shape)
    for tile in np.unique(t):
        m = t == tile
        out[m] = _to_left_handed(base[m] @ _TILE_ROTATIONS[tile].T)
    return out


def corner_lonlat_at(n: int, t, a, b):
    """(lon, lat) of the corners (t, a, b) alone."""
    t, a, b = np.broadcast_arrays(t, a, b)
    lon, lat = xyz_to_lonlat(corner_xyz_at(n, t, a, b))
    if n % 2 == 0:
        # exact poles: tile 3's center is the north pole, tile 6's the
        # south pole
        m = n // 2
        centre = (a == m) & (b == m)
        lon = np.where(centre & ((t == 2) | (t == 5)), 0.0, lon)
        lat = np.where(centre & (t == 2), 0.5 * PI, lat)
        lat = np.where(centre & (t == 5), -0.5 * PI, lat)
    return lon, lat


def xyz_midpoint(*points):
    total = sum(points)
    return total / np.sqrt((total ** 2).sum(axis=-1, keepdims=True))

