"""Baroclinic-wave initial condition on the cubed sphere (global-view).

The numpy derivation of `pace_tpu.models.fv3.init.baroclinic` (reference
ai2cm/pace fv3core/pace/fv3core/initialization/baroclinic.py:436): the
Jablonowski & Williamson analytic state is evaluated on all six tiles at
once, winds are projected onto the local grid directions with the ee/es/ew
unit vectors and Simpson-averaged along the staggered edges, scalars are
9-point cell averages, and halos are filled with the topology gather maps.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.grid import geometry
from pace_torch.models.fv3 import state as state_mod
from pace_torch.models.fv3.init import jablonowski_williamson as jw
from pace_torch.parallel.topology import get_topology
from pace_torch.utils import constants
from pace_torch.utils.gridtools import GridSizing

PTOP_MIN = 1e-8


def initialize_delp(ps, ak, bk):
    return (
        ak[None, None, None, 1:] - ak[None, None, None, :-1]
        + ps[..., None] * (bk[None, None, None, 1:] - bk[None, None, None, :-1])
    )


def initialize_edge_pressure(delp, ptop):
    pe = np.zeros(delp.shape[:-1] + (delp.shape[-1] + 1,))
    pe[..., 0] = ptop
    pe[..., 1:] = ptop + np.cumsum(delp, axis=-1)
    return pe


def initialize_log_pressure_interfaces(pe, ptop):
    peln = np.zeros_like(pe)
    peln[..., 0] = np.log(ptop)
    peln[..., 1:] = np.log(pe[..., 1:])
    return peln


def initialize_kappa_pressures(pe, peln, ptop):
    kappa = constants.KAPPA
    pk = np.zeros_like(pe)
    pk[..., 0] = ptop ** kappa
    pk[..., 1:] = np.exp(kappa * np.log(pe[..., 1:]))
    pkz = (pk[..., 1:] - pk[..., :-1]) / (kappa * (peln[..., 1:] - peln[..., :-1]))
    return pk, pkz


def _projected_wind(eta_v, lon_pt, lat_pt, vec):
    """Perturbed zonal wind at the given points, projected onto a grid
    direction vector (Cartesian x/y components only — the zonal direction
    has no z component)."""
    wind = jw.baroclinic_perturbed_zonal_wind(eta_v, lon_pt, lat_pt)
    proj = vec[..., 1] * np.cos(lon_pt) - vec[..., 0] * np.sin(lon_pt)
    return wind * proj[..., None]


def _cell_average_nine(fn, args, lon, lat, lat_agrid):
    """9-point (Simpson) cell average of a latitude-dependent field; lon/lat
    are corners over (n+1, n+1) bracketing the (n, n) cells."""
    _, lat2 = geometry.lon_lat_midpoint(
        lon[:, :-1, :], lon[:, 1:, :], lat[:, :-1, :], lat[:, 1:, :]
    )  # x-direction edge midpoints (south rows), (n, n+1)
    _, lat3 = geometry.lon_lat_midpoint(
        lon[:, 1:, :-1], lon[:, 1:, 1:], lat[:, 1:, :-1], lat[:, 1:, 1:]
    )  # east edges, (n, n)
    _, lat4 = geometry.lon_lat_midpoint(
        lon[:, :-1, 1:], lon[:, 1:, 1:], lat[:, :-1, 1:], lat[:, 1:, 1:]
    )  # north rows, (n, n)
    _, lat5 = geometry.lon_lat_midpoint(
        lon[:, :, :-1], lon[:, :, 1:], lat[:, :, :-1], lat[:, :, 1:]
    )  # west edges, (n+1, n)
    pt1 = fn(*args, lat=lat_agrid)
    pt2 = fn(*args, lat=lat2[:, :, :-1])
    pt3 = fn(*args, lat=lat3)
    pt4 = fn(*args, lat=lat4)
    pt5 = fn(*args, lat=lat5[:, :-1, :])
    pt6 = fn(*args, lat=lat[:, :-1, :-1])
    pt7 = fn(*args, lat=lat[:, 1:, :-1])
    pt8 = fn(*args, lat=lat[:, 1:, 1:])
    pt9 = fn(*args, lat=lat[:, :-1, 1:])
    return (
        0.25 * pt1 + 0.125 * (pt2 + pt3 + pt4 + pt5)
        + 0.0625 * (pt6 + pt7 + pt8 + pt9)
    )


def init_baroclinic_state_numpy(
    raw_metrics: dict,
    vertical,
    sizing: GridSizing,
    adiabatic: bool = False,
    hydrostatic: bool = False,
    moist_phys: bool = True,
):
    """Returns a dict of float64 numpy arrays for every DycoreState field."""
    hz = raw_metrics["horizontal"]
    n, h = sizing.n, sizing.halo
    topo = get_topology(n, h)
    ak = np.asarray(vertical.ak)
    bk = np.asarray(vertical.bk)
    ptop = vertical.ptop

    arrays = state_mod.zeros_numpy(sizing)

    ci = slice(h, h + n)       # compute cells
    cie = slice(h, h + n + 1)  # compute interfaces
    c3 = (slice(None), ci, ci)

    # pressure setup over the whole storage (cheap; halos then exact)
    arrays["ps"][:] = jw.SURFACE_PRESSURE
    arrays["delp"][:] = initialize_delp(arrays["ps"], ak, bk)
    arrays["pe"][:] = initialize_edge_pressure(arrays["delp"], ptop)
    arrays["peln"][:] = initialize_log_pressure_interfaces(arrays["pe"], ptop)
    arrays["pk"], arrays["pkz"] = initialize_kappa_pressures(
        arrays["pe"], arrays["peln"], ptop
    )
    eta, eta_v = jw.compute_eta(ak, bk)

    lon = hz["lon"]
    lat = hz["lat"]
    lon_a = hz["lon_agrid"]
    lat_a = hz["lat_agrid"]
    ee1, ee2 = hz["ee1"], hz["ee2"]
    es1, ew2 = hz["es1"], hz["ew2"]

    # --- v wind: x-interfaces (i in [h, h+n]), y cells (j in [h, h+n)) ----
    uu1 = _projected_wind(
        eta_v, lon[:, cie, h + 1:h + n + 1], lat[:, cie, h + 1:h + n + 1],
        ee2[:, cie, h + 1:h + n + 1],
    )
    uu3 = _projected_wind(
        eta_v, lon[:, cie, ci], lat[:, cie, ci], ee2[:, cie, ci]
    )
    mlon, mlat = geometry.lon_lat_midpoint(
        lon[:, cie, ci], lon[:, cie, h + 1:h + n + 1],
        lat[:, cie, ci], lat[:, cie, h + 1:h + n + 1],
    )
    uu2 = _projected_wind(eta_v, mlon, mlat, ew2[:, cie, ci])
    arrays["v"][:, cie, ci] = 0.25 * (uu1 + 2.0 * uu2 + uu3)

    # --- u wind: x cells, y-interfaces ------------------------------------
    uu1 = _projected_wind(
        eta_v, lon[:, ci, cie], lat[:, ci, cie], ee1[:, ci, cie]
    )
    uu3 = _projected_wind(
        eta_v, lon[:, h + 1:h + n + 1, cie], lat[:, h + 1:h + n + 1, cie],
        ee1[:, h + 1:h + n + 1, cie],
    )
    mlon, mlat = geometry.lon_lat_midpoint(
        lon[:, ci, cie], lon[:, h + 1:h + n + 1, cie],
        lat[:, ci, cie], lat[:, h + 1:h + n + 1, cie],
    )
    uu2 = _projected_wind(eta_v, mlon, mlat, es1[:, ci, cie])
    arrays["u"][:, ci, cie] = 0.25 * (uu1 + 2.0 * uu2 + uu3)

    # --- temperature and surface geopotential ------------------------------
    t_mean = jw.horizontally_averaged_temperature(eta)
    lon_b = lon[:, h:h + n + 1, h:h + n + 1]
    lat_b = lat[:, h:h + n + 1, h:h + n + 1]
    arrays["pt"][c3] = _cell_average_nine(
        jw.temperature, [eta, eta_v, t_mean], lon_b, lat_b, lat_a[:, ci, ci]
    )
    arrays["phis"][:] = 1.0e25
    arrays["phis"][:, ci, ci] = _cell_average_nine(
        jw.surface_geopotential_perturbation, [], lon_b, lat_b,
        lat_a[:, ci, ci],
    )

    if not hydrostatic:
        arrays["w"][c3] = 0.0
        arrays["delz"][c3] = constants.RDG * arrays["pt"][c3] * (
            arrays["peln"][c3 + (slice(1, None),)]
            - arrays["peln"][c3 + (slice(None, -1),)]
        )

    if not adiabatic:
        arrays["qvapor"][c3] = jw.specific_humidity(
            arrays["delp"][c3],
            arrays["peln"][c3],
            lat_a[:, ci, ci],
        )
        arrays["pt"][c3] = arrays["pt"][c3] / (
            1.0 + constants.ZVIR * arrays["qvapor"][c3]
        )

    # --- p_var: auxiliary hydrostatic pressure fields -----------------------
    arrays["ps"][:] = arrays["pe"][..., -1]
    if ptop < PTOP_MIN:
        ak1 = (constants.KAPPA + 1.0) / constants.KAPPA
        arrays["peln"][..., 0] = arrays["peln"][..., 1] - ak1
    else:
        arrays["peln"][..., 0] = np.log(ptop)
    if not hydrostatic:
        arrays["delz"][c3] = constants.RDG * arrays["pt"][c3] * (
            arrays["peln"][c3 + (slice(1, None),)]
            - arrays["peln"][c3 + (slice(None, -1),)]
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        if moist_phys:
            pkz = np.exp(constants.KAPPA * np.log(
                constants.RDG * arrays["delp"][c3] * arrays["pt"][c3]
                * (1.0 + constants.ZVIR * arrays["qvapor"][c3])
                / arrays["delz"][c3]
            ))
        else:
            pkz = np.exp(constants.KAPPA * np.log(
                constants.RDG * arrays["delp"][c3] * arrays["pt"][c3]
                / arrays["delz"][c3]
            ))
    arrays["pkz"][c3] = pkz

    # --- halo updates --------------------------------------------------------
    from pace_torch.grid.generation import _halo_pair_np, _halo_scalar_np

    arrays["phis"] = _halo_scalar_np(topo, arrays["phis"], "center")
    arrays["u"], arrays["v"] = _halo_pair_np(
        topo, arrays["u"], arrays["v"], "y_iface", "x_iface", signed=True
    )
    return arrays


def init_baroclinic_state(
    sizing: GridSizing,
    adiabatic: bool = False,
    hydrostatic: bool = False,
    moist_phys: bool = True,
    *,
    device="cuda",
    dtype=torch.float32,
    scatter=None,
):
    """Build a DycoreState with the J&W baroclinic wave (one rank's part
    where `scatter` is given: the whole cube is built on the host and
    cut)."""
    from pace_torch.grid import eta as eta_mod
    from pace_torch.grid.generation import _generate_metric_terms

    raw = _generate_metric_terms(sizing.n, sizing.halo)
    vertical = eta_mod.set_hybrid_pressure_coefficients(sizing.nz)
    arrays = init_baroclinic_state_numpy(
        raw, vertical, sizing, adiabatic, hydrostatic, moist_phys
    )
    return state_mod.DycoreState.from_numpy(arrays, device, dtype, scatter)
