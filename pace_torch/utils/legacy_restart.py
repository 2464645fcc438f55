"""Legacy Fortran restart reader (`open_restart`).

Port of `pace_tpu.utils.legacy_restart` (reference ai2cm/pace
util/pace/util/_legacy_restart.py): reads the tile-sharded NetCDF restart
files written by the Fortran FV3 model (`fv_core.res.tile{1..6}.nc`,
`fv_srf_wnd.res.tile*.nc`, `fv_tracer.res.tile*.nc`, optional
`sfc_data`/`phy_data`, plus the `coupler.res` text timestamp) into
whole-cube (6, N, N[, nz]) numpy arrays in the port's padded global
storage layout, or into the block one rank holds (its tiles' files only).

Files are NetCDF3 classic / 64-bit-offset, read with scipy.  Reference
behaviours preserved: file naming incl. `label` prefix
(_legacy_restart.py:80-92), restart-variable name mapping (_properties.py
RESTART_PROPERTIES), (Time, z, y, x) -> (x, y, z) axis order, and
coupler.res date parsing (io.py:65-69).
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Iterable, Optional

import numpy as np

RESTART_NAMES = ("fv_core.res", "fv_srf_wnd.res", "fv_tracer.res")
RESTART_OPTIONAL_NAMES = ("sfc_data", "phy_data")
COUPLER_RES_NAME = "coupler.res"

# Fortran restart variable -> (DycoreState field, stagger) where stagger is
# (extra_x, extra_y) interface points beyond the n x n cell grid.
RESTART_TO_FIELD = {
    "u": ("u", (0, 1)),       # D-grid x-wind on y-interfaces
    "v": ("v", (1, 0)),       # D-grid y-wind on x-interfaces
    "W": ("w", (0, 0)),
    "DZ": ("delz", (0, 0)),
    "T": ("pt", (0, 0)),
    "delp": ("delp", (0, 0)),
    "phis": ("phis", (0, 0)),
    "ua": ("ua", (0, 0)),
    "va": ("va", (0, 0)),
    "sphum": ("qvapor", (0, 0)),
    "liq_wat": ("qliquid", (0, 0)),
    "rainwat": ("qrain", (0, 0)),
    "ice_wat": ("qice", (0, 0)),
    "snowwat": ("qsnow", (0, 0)),
    "graupel": ("qgraupel", (0, 0)),
    "o3mr": ("qo3mr", (0, 0)),
    "sgs_tke": ("qsgs_tke", (0, 0)),
    "cld_amt": ("qcld", (0, 0)),
    "u_srf": ("u_srf", (0, 0)),
    "v_srf": ("v_srf", (0, 0)),
}


def _prepend_label(filename: str, label: str) -> str:
    return f"{label}.{filename}" if label else filename


def restart_filenames(dirname: str, tile_index: int, label: str = ""):
    """Filenames for one tile (reference _legacy_restart.py:80-92)."""
    suffix = f".tile{tile_index + 1}.nc"
    out = []
    for name in RESTART_NAMES + RESTART_OPTIONAL_NAMES:
        filename = os.path.join(dirname, _prepend_label(name, label) + suffix)
        if name in RESTART_NAMES or os.path.exists(filename):
            out.append(filename)
    return out


def get_current_date_from_coupler_res(path: str) -> datetime:
    """Third line of coupler.res holds the current date as 6 integers
    (reference io.py:65-69; calendar type collapsed to datetime)."""
    with open(path) as f:
        f.readline()
        f.readline()
        tokens = f.readline().split()
    year, month, day, hour, minute, second = (int(t) for t in tokens[:6])
    return datetime(year, month, day, hour, minute, second)


def _read_tile_vars(filename: str, only_restart_names, h: int,
                    box) -> Dict[str, tuple]:
    """The restart variables of one tile file, each as (its (x, y) size,
    the lines of it inside the storage window `box` (a partition `Box`
    whose i and j are read) in (x, y[, z]) order, and where they start in
    the window).  Read through a memory map: no more than the window of a
    variable is copied."""
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(filename, "r", mmap=True) as nc:
        for var_name in list(nc.variables):
            if var_name not in RESTART_TO_FIELD:
                continue
            if only_restart_names is not None \
                    and var_name not in only_restart_names:
                continue
            var = nc.variables[var_name]
            data = var.data
            # the Fortran files give 3-D fields as (Time, z, y, x) and
            # surface fields as (Time, y, x): drop the Time axis by its name
            # (the reference package goes by rank, and so keeps a surface
            # field's Time axis as a trailing level of size 1)
            if data.ndim == 4 or var.dimensions[:1] == ("Time",):
                data = data[0]
            ny, nx = data.shape[-2:]
            x0, x1 = max(box.i0 - h, 0), min(box.i1 - h, nx)
            y0, y1 = max(box.j0 - h, 0), min(box.j1 - h, ny)
            window = np.array(data[..., y0:max(y1, y0), x0:max(x1, x0)],
                              dtype=np.float64)
            # (z, y, x) -> (x, y, z); (y, x) -> (x, y)
            window = np.ascontiguousarray(
                np.transpose(window, (2, 1, 0)) if window.ndim == 3
                else window.T)
            out[var_name] = ((nx, ny), window, (x0 + h - box.i0,
                                                y0 + h - box.j0))
            del var, data
    return out


def open_restart(
    dirname: str,
    sizing,
    label: str = "",
    only_names: Optional[Iterable[str]] = None,
    dtype=np.float32,
    part=None,
) -> Dict[str, np.ndarray]:
    """Load Fortran restart files into whole-cube padded arrays, or into
    the block a rank holds.

    Args:
        dirname: directory holding the .res tile files
        sizing: GridSizing (n, nz, halo) of the target storage
        label: optional filename prefix (reference `label` arg)
        only_names: optional subset of DycoreState field names to load
        part: a rank's `RankPart` (`Partition.part(rank)`): only the files
            of its tiles are read, and of each variable its block
    Returns:
        dict of field name -> (6, N, N[, nz]) numpy array, or the block's
        (tiles, Ni, Nj[, nz]) (halos zero, compute domain filled), plus
        "time" when coupler.res exists.
    """
    from pace_torch.parallel.partition import RankPart

    n, h = sizing.n, sizing.halo
    part = part if part is not None else RankPart.whole(n, h)
    box = part.box
    only_restart = None
    if only_names is not None:
        only_restart = {
            rn for rn, (fn, _) in RESTART_TO_FIELD.items()
            if fn in set(only_names)
        }

    per_tile: list = []
    for tile in range(box.t0, box.t1):
        filenames = restart_filenames(dirname, tile, label)
        if not any(os.path.exists(f) for f in filenames):
            raise ValueError(f"no restart files found at {dirname}")
        tile_vars: Dict[str, tuple] = {}
        for filename in filenames:
            if os.path.exists(filename):
                tile_vars.update(_read_tile_vars(filename, only_restart, h,
                                                 box))
        per_tile.append(tile_vars)

    state: Dict[str, np.ndarray] = {}
    for rn in per_tile[0]:
        field, (ex, ey) = RESTART_TO_FIELD[rn]
        sample = per_tile[0][rn][1]
        block = np.zeros(part.shape + sample.shape[2:], dtype)
        for t, tile_vars in enumerate(per_tile):
            (nx, ny), data, (i0, j0) = tile_vars[rn]
            if (nx, ny) != (n + ex, n + ey):
                raise ValueError(
                    f"{rn}: tile {box.t0 + t + 1} has shape {(nx, ny)}, "
                    f"expected ({n + ex}, {n + ey})"
                )
            block[t, i0:i0 + data.shape[0], j0:j0 + data.shape[1]] = data
        state[field] = block

    coupler = os.path.join(dirname, _prepend_label(COUPLER_RES_NAME, label))
    if os.path.exists(coupler):
        state["time"] = get_current_date_from_coupler_res(coupler)
    return state
