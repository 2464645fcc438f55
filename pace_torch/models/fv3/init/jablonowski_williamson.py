"""Jablonowski & Williamson (QJRMS 2006) baroclinic-wave analytic state.

Implements the published test-case equations (JW06 eqs. 1-11 and the DCMIP
2016 variants) used for the baroclinic initial condition, as in the
reference ai2cm/pace fv3core/pace/fv3core/initialization/
baroclinic_jablonowski_williamson.py.  All functions are vectorized numpy
over arbitrary leading dims.
"""

from __future__ import annotations

import numpy as np

from pace_torch.grid import geometry
from pace_torch.utils import constants

U0 = 35.0                      # max zonal jet speed [m/s]
PCEN = (np.pi / 9.0, 2.0 * np.pi / 9.0)  # perturbation center (20E, 40N)
U1 = 1.0                       # perturbation amplitude [m/s]
ETA_0 = 0.252
ETA_SURFACE = 1.0
ETA_TROPOPAUSE = 0.2
T_0 = 288.0
DELTA_T = 480000.0
LAPSE_RATE = 0.005
SURFACE_PRESSURE = 1.0e5
R_PERTURB = constants.RADIUS / 10.0


def vertical_coordinate(eta_value):
    """eta_v auxiliary coordinate (JW06 eq. 1)."""
    return (eta_value - ETA_0) * np.pi * 0.5


def compute_eta(ak, bk):
    eta = 0.5 * ((ak[:-1] + ak[1:]) / SURFACE_PRESSURE + bk[:-1] + bk[1:])
    return eta, vertical_coordinate(eta)


def zonal_wind(eta_v, lat):
    """JW06 eq. 2; lat has shape [...], eta_v [nz]; returns [..., nz]."""
    return (
        U0 * np.cos(eta_v) ** 1.5 * (np.sin(2.0 * lat[..., None]) ** 2)
    )


def baroclinic_perturbed_zonal_wind(eta_v, lon, lat):
    u = zonal_wind(eta_v, lat)
    r = geometry.great_circle_distance_lon_lat(
        PCEN[0], lon, PCEN[1], lat, constants.RADIUS
    )[..., None]
    perturbation = np.where(
        (r / R_PERTURB) ** 2 < 40.0, U1 * np.exp(-((r / R_PERTURB) ** 2)), 0.0
    )
    return u + perturbation


def horizontally_averaged_temperature(eta):
    """JW06 eqs. 4-5."""
    t_mean = T_0 * eta ** (constants.RDGAS * LAPSE_RATE / constants.GRAV)
    return np.where(
        eta < ETA_TROPOPAUSE,
        t_mean + DELTA_T * (ETA_TROPOPAUSE - np.minimum(eta, ETA_TROPOPAUSE)) ** 5,
        t_mean,
    )


def temperature(eta, eta_v, t_mean, lat):
    """JW06 eq. 6."""
    lat = lat[..., None]
    return t_mean + 0.75 * (eta * np.pi * U0 / constants.RDGAS) * np.sin(
        eta_v
    ) * np.sqrt(np.cos(eta_v)) * (
        (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
        * 2.0 * U0 * np.cos(eta_v) ** 1.5
        + (
            1.6 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
            - np.pi / 4.0
        ) * constants.RADIUS * constants.OMEGA
    )


def geopotential_perturbation(lat, eta_value):
    """JW06 eq. 7, perturbation part only."""
    u_comp = U0 * np.cos(eta_value) ** 1.5
    return u_comp * (
        (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
        * u_comp
        + (
            1.6 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
            - np.pi / 4.0
        ) * constants.RADIUS * constants.OMEGA
    )


def surface_geopotential_perturbation(lat):
    return geopotential_perturbation(lat, vertical_coordinate(ETA_SURFACE))


def specific_humidity(delp, peln, lat_agrid):
    """DCMIP 2016 eq. 18 (without tropopause cutoff)."""
    pw = 34000.0
    q0 = 0.021
    ptmp = delp / (peln[..., 1:] - peln[..., :-1]) - SURFACE_PRESSURE
    return (
        q0
        * np.exp(-((lat_agrid[..., None] / PCEN[1]) ** 4))
        * np.exp(-((ptmp / pw) ** 2))
    )
