"""Reed-Jablonowski tropical cyclone analytic initial condition.

The numpy derivation of `pace_tpu.models.fv3.init.tropical_cyclone`
(reference ai2cm/pace fv3core/pace/fv3core/initialization/
tropical_cyclone.py `init_tc_state`, FV3 test_case 55): an axisymmetric
warm-core vortex in gradient-wind balance at (lon 180E, lat 10N) with
moisture decaying away from the surface and the storm core.  The float64
arithmetic is the reference package's, in its order, so the two packages
build the same state bit for bit.

The vertical coordinate uses the case's own 79-level ak/bk table
(tropical_cyclone.py:228-405, stored in grid/data/tc_hybrid_coefficients.npz).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pace_torch.grid import geometry
from pace_torch.models.fv3 import state as state_mod
from pace_torch.utils import constants as con
from pace_torch.utils.gridtools import GridSizing

_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))),
    "grid", "data", "tc_hybrid_coefficients.npz",
)

TC = dict(
    dp=1115.0, exppr=1.5, exppz=2.0, gamma=0.007, lat_tc=10.0,
    lon_tc=180.0, p_ref=101500.0, ptop=1.0, qtrop=1e-11, q00=0.021,
    rp=282000.0, Ts0=302.15, ztrop=15000.0, zp=7000.0, zq1=3000.0,
    zq2=8000.0,
)


def _calc():
    t00 = TC["Ts0"] * (1.0 + con.ZVIR * TC["q00"])
    p0 = (np.deg2rad(TC["lon_tc"]), np.deg2rad(TC["lat_tc"]))
    return dict(
        t00=t00, p0=p0,
        exponent=con.RDGAS * TC["gamma"] / con.GRAV,
        cor=2.0 * con.OMEGA * np.sin(np.deg2rad(TC["lat_tc"])),
        ttrop=t00 - TC["gamma"] * TC["ztrop"],
    )


def _surface_pressure(lon, lat, p0):
    r = geometry.great_circle_distance_lon_lat(
        p0[0], lon, p0[1], lat, con.RADIUS
    )
    return TC["p_ref"] - TC["dp"] * np.exp(-((r / TC["rp"]) ** 1.5))


def _height_from_pressure(p_mid, ps, calc):
    return (calc["t00"] / TC["gamma"]) * (
        1.0 - (p_mid / ps[..., None]) ** calc["exponent"]
    )


def _qvapor_of_height(height):
    return (
        TC["q00"] * np.exp(-height / TC["zq1"])
        * np.exp(-((height / TC["zq2"]) ** TC["exppz"]))
    )


def _pt_of_height(height, qvapor, r, calc):
    """Balanced temperature (reference _calculate_pt_height)."""
    bb = np.exp((height / TC["zp"]) ** TC["exppz"])
    dd = np.exp((r / TC["rp"]) ** TC["exppr"])
    ee = 1.0 - TC["p_ref"] / TC["dp"] * dd[..., None] * bb
    ff = con.GRAV * TC["zp"] ** TC["exppz"] * ee
    gg = calc["t00"] - TC["gamma"] * height
    hh = 1.0 + TC["exppz"] * con.RDGAS * gg * height / ff
    return gg / (1.0 + con.ZVIR * qvapor) / hh


def _tangential_wind(height, d, d1, d2, r, calc):
    """Gradient-wind tangential velocity components (reference
    _calculate_utmp; returns (u_east, v_north) multipliers)."""
    bb = r / TC["rp"]
    ee = 1.0 - TC["p_ref"] / TC["dp"] * np.exp(
        (bb[..., None]) ** TC["exppr"]
    ) * np.exp((height / TC["zp"]) ** TC["exppz"])
    ff = con.GRAV * TC["zp"] ** TC["exppz"]
    gg = calc["t00"] - TC["gamma"] * height
    hh = TC["exppz"] * height * con.RDGAS * gg / ff + ee
    ii = calc["cor"] * r / 2.0
    kk = (
        ii[..., None] ** 2
        - TC["exppr"] * bb[..., None] ** TC["exppr"] * con.RDGAS * gg / hh
    )
    ll = -calc["cor"] * r[..., None] / 2.0 + np.sqrt(np.maximum(kk, 0.0))
    utmp = ll / np.maximum(d[..., None], 1e-15)
    return utmp * d1[..., None], utmp * d2[..., None]


def _edge_wind(lon1, lat1, lon2, lat2, ak, bk, calc):
    """Wind component along the edge from corner (lon1,lat1) to
    (lon2,lat2), evaluated at the edge midpoint."""
    mlon, mlat = geometry.lon_lat_midpoint(lon1, lon2, lat1, lat2)
    p0 = calc["p0"]
    d1 = np.sin(p0[1]) * np.cos(mlat) - np.cos(p0[1]) * np.sin(mlat) \
        * np.cos(mlon - p0[0])
    d2 = np.cos(p0[1]) * np.sin(mlon - p0[0])
    d = np.maximum(np.sqrt(d1 ** 2 + d2 ** 2), 1e-15)
    r = geometry.great_circle_distance_lon_lat(
        p0[0], mlon, p0[1], mlat, con.RADIUS
    )
    ps = TC["p_ref"] - TC["dp"] * np.exp(-((r / TC["rp"]) ** 1.5))
    pe = ak[None, None, None, :] + ps[..., None] * bk[None, None, None, :]
    p_mid = 0.5 * (pe[..., :-1] + pe[..., 1:])
    height = _height_from_pressure(p_mid, ps, calc)
    ue, ve = _tangential_wind(height, d, d1, d2, r, calc)
    p1 = np.stack([lon1, lat1], -1)
    p2 = np.stack([lon2, lat2], -1)
    unit_dir = geometry.get_unit_vector_direction(p1, p2)
    exv, eyv = geometry.lonlat_unit_vectors(mlon, mlat)
    proj = (
        ue * (unit_dir * exv).sum(-1)[..., None]
        + ve * (unit_dir * eyv).sum(-1)[..., None]
    )
    return np.where(height > TC["ztrop"], 0.0, proj)


def tc_coefficients(nz: int, ak=None, bk=None):
    """The (ak, bk) the column is integrated against: the given tables, the
    case's own 79-level table, or the standard hybrid tables
    (grid/eta.py) at other level counts."""
    if ak is None or bk is None:
        if nz == 79:
            data = np.load(_DATA)
            ak, bk = data["ak"], data["bk"]
        else:
            from pace_torch.grid import eta

            coeffs = eta.set_hybrid_pressure_coefficients(nz)
            ak, bk = coeffs.ak, coeffs.bk
    ak = np.asarray(ak, np.float64)
    bk = np.asarray(bk, np.float64)
    if ak.shape != (nz + 1,) or bk.shape != (nz + 1,):
        raise ValueError(
            f"ak/bk must have length nz+1={nz + 1}, "
            f"got {ak.shape}/{bk.shape}"
        )
    return ak, bk


def init_tc_state_numpy(raw_metrics: dict, sizing: GridSizing, ak, bk):
    """Returns a dict of float64 numpy arrays for every DycoreState field;
    `raw_metrics` are `grid.generation._generate_metric_terms`'s."""
    N = sizing.N
    calc = _calc()
    hz = raw_metrics["horizontal"]
    lon, lat = hz["lon"], hz["lat"]
    dx, dy = hz["dx"], hz["dy"]
    dxa, dya = hz["dxa"], hz["dya"]
    lon_a = np.nan_to_num(hz["lon_agrid"], nan=0.0)
    lat_a = np.nan_to_num(hz["lat_agrid"], nan=0.0)
    out = state_mod.zeros_numpy(sizing)

    # surface pressure and column structure on the A-grid
    ps = _surface_pressure(lon_a, lat_a, calc["p0"])
    delp = (
        ak[None, None, None, 1:] - ak[None, None, None, :-1]
        + ps[..., None] * (bk[None, None, None, 1:]
                           - bk[None, None, None, :-1])
    )
    pe = np.concatenate(
        [np.full(ps.shape + (1,), TC["ptop"]),
         TC["ptop"] + np.cumsum(delp, -1)], -1,
    )
    peln = np.log(pe)
    pk = np.exp(con.KAPPA * peln)
    pkz = (pk[..., 1:] - pk[..., :-1]) / (
        con.KAPPA * (peln[..., 1:] - peln[..., :-1])
    )
    p_mid = 0.5 * (pe[..., :-1] + pe[..., 1:])
    height = _height_from_pressure(p_mid, ps, calc)
    qvapor = _qvapor_of_height(height)
    r_a = geometry.great_circle_distance_lon_lat(
        calc["p0"][0], lon_a, calc["p0"][1], lat_a, con.RADIUS
    )
    pt = _pt_of_height(height, qvapor, r_a, calc)
    trop = height > TC["ztrop"]
    qvapor = np.where(trop, TC["qtrop"], qvapor)
    pt = np.where(trop, calc["ttrop"], pt)
    delz = (
        con.RDGAS * pt * (1.0 + con.ZVIR * qvapor) / con.GRAV
        * np.log(pe[..., :-1] / pe[..., 1:])
    )

    # D-grid winds from edge-midpoint gradient-wind balance
    act = slice(0, N - 1)
    nz = sizing.nz
    u = np.zeros((6, N, N, nz))
    u[:, :-1] = _edge_wind(
        lon[:, act], lat[:, act], lon[:, 1:], lat[:, 1:], ak, bk, calc
    )
    v = np.zeros((6, N, N, nz))
    v[:, :, :-1] = _edge_wind(
        lon[:, :, act], lat[:, :, act], lon[:, :, 1:], lat[:, :, 1:],
        ak, bk, calc,
    )

    # A-grid winds by dx/dy-weighted averaging (reference
    # _interpolate_winds_dgrid_agrid, vort=True branch)
    ua = np.zeros_like(u)
    va = np.zeros_like(v)
    # padding cells divide by zero/NaN geometry; nan_to_num below zeroes them
    with np.errstate(invalid="ignore", divide="ignore"):
        ua[:, :, :-1] = 0.5 * (
            u[:, :, :-1] * dx[:, :, :-1, None] + u[:, :, 1:] * dx[:, :, 1:, None]
        ) / dxa[:, :, :-1, None]
        va[:, :-1] = 0.5 * (
            v[:, :-1] * dy[:, :-1, :, None] + v[:, 1:] * dy[:, 1:, :, None]
        ) / dya[:, :-1, :, None]

    for name, val in (
        ("delp", delp), ("delz", delz), ("pe", pe), ("peln", peln),
        ("pk", pk), ("pkz", pkz), ("ps", pe[..., -1]), ("pt", pt),
        ("qvapor", qvapor), ("u", u), ("v", v),
        ("ua", np.nan_to_num(ua)), ("va", np.nan_to_num(va)),
    ):
        out[name] = np.nan_to_num(val, nan=0.0, posinf=0.0, neginf=0.0)
    return out


def init_tc_state(sizing: GridSizing, ak=None, bk=None, *, device="cuda",
                  dtype=torch.float32, scatter=None) -> state_mod.DycoreState:
    """Build a DycoreState for the tropical cyclone test case (one rank's
    part where `scatter` is given).

    The analytic column is integrated against whatever ak/bk table is
    provided (like the reference, which accepts any vertical grid): the
    SHiELD TC 79-level table is the default; other level counts fall back
    to the standard hybrid tables or explicit ak/bk."""
    from pace_torch.grid.generation import _generate_metric_terms

    ak, bk = tc_coefficients(sizing.nz, ak, bk)
    raw = _generate_metric_terms(sizing.n, sizing.halo)
    arrays = init_tc_state_numpy(raw, sizing, ak, bk)
    return state_mod.DycoreState.from_numpy(arrays, device, dtype, scatter)
