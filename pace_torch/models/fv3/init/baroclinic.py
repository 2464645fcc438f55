"""Baroclinic-wave initial condition on the cubed sphere (global-view).

The numpy derivation of `pace_tpu.models.fv3.init.baroclinic` (reference
ai2cm/pace fv3core/pace/fv3core/initialization/baroclinic.py:436): the
Jablonowski & Williamson analytic state is evaluated on all six tiles at
once, winds are projected onto the local grid directions with the ee/es/ew
unit vectors and Simpson-averaged along the staggered edges, scalars are
9-point cell averages, and the halos of u, v and phis hold what the
topology's gather maps read.  A rank evaluates the same formulas on its
own block only (`RankPart`), its halo points at their gather sources.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pace_torch.grid import geometry
from pace_torch.models.fv3 import state as state_mod
from pace_torch.models.fv3.init import jablonowski_williamson as jw
from pace_torch.parallel.partition import RankPart, is_compute
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


def _cell_average_nine(fn, args, corners, lat_agrid):
    """9-point (Simpson) cell average of a latitude-dependent field at
    cells given by their corners' (lon, lat): those at (i, j), (i+1, j),
    (i, j+1) and (i+1, j+1)."""
    (lon00, lat00), (lon10, lat10), (lon01, lat01), (lon11, lat11) = corners
    _, lat2 = geometry.lon_lat_midpoint(lon00, lon10, lat00, lat10)  # south
    _, lat3 = geometry.lon_lat_midpoint(lon10, lon11, lat10, lat11)  # east
    _, lat4 = geometry.lon_lat_midpoint(lon01, lon11, lat01, lat11)  # north
    _, lat5 = geometry.lon_lat_midpoint(lon00, lon01, lat00, lat01)  # west
    pt1 = fn(*args, lat=lat_agrid)
    pt2 = fn(*args, lat=lat2)
    pt3 = fn(*args, lat=lat3)
    pt4 = fn(*args, lat=lat4)
    pt5 = fn(*args, lat=lat5)
    pt6 = fn(*args, lat=lat00)
    pt7 = fn(*args, lat=lat10)
    pt8 = fn(*args, lat=lat11)
    pt9 = fn(*args, lat=lat01)
    return (
        0.25 * pt1 + 0.125 * (pt2 + pt3 + pt4 + pt5)
        + 0.0625 * (pt6 + pt7 + pt8 + pt9)
    )


class _Points:
    """The analytic fields at lists of storage points (t, i, j) of the
    whole cube's metric terms `hz`: u on y-interfaces, v on x-interfaces
    (Simpson averages along the edge from the point to its i + 1 or j + 1
    neighbour) and 9-point cell averages.  Each takes its inputs gathered
    into contiguous arrays, so a point's value does not depend on which
    other points are evaluated with it."""

    def __init__(self, hz, eta_v):
        self.hz, self.eta_v = hz, eta_v

    def _wind(self, t, i, j, di, dj, vec, mid_vec):
        lon, lat = self.hz["lon"], self.hz["lat"]
        lon0, lat0 = lon[t, i, j], lat[t, i, j]
        lon1, lat1 = lon[t, i + di, j + dj], lat[t, i + di, j + dj]
        uu0 = _projected_wind(self.eta_v, lon0, lat0, vec[t, i, j])
        uu1 = _projected_wind(self.eta_v, lon1, lat1,
                              vec[t, i + di, j + dj])
        mlon, mlat = geometry.lon_lat_midpoint(lon0, lon1, lat0, lat1)
        uu2 = _projected_wind(self.eta_v, mlon, mlat, mid_vec[t, i, j])
        return uu0, uu1, uu2

    def u(self, t, i, j):
        uu1, uu3, uu2 = self._wind(t, i, j, 1, 0, self.hz["ee1"],
                                   self.hz["es1"])
        return 0.25 * (uu1 + 2.0 * uu2 + uu3)

    def v(self, t, i, j):
        uu3, uu1, uu2 = self._wind(t, i, j, 0, 1, self.hz["ee2"],
                                   self.hz["ew2"])
        return 0.25 * (uu1 + 2.0 * uu2 + uu3)

    def cell_average(self, fn, args, t, i, j):
        lon, lat = self.hz["lon"], self.hz["lat"]
        corners = [(lon[t, i + di, j + dj], lat[t, i + di, j + dj])
                   for di, dj in ((0, 0), (1, 0), (0, 1), (1, 1))]
        return _cell_average_nine(fn, args, corners,
                                  self.hz["lat_agrid"][t, i, j])


def init_baroclinic_state_numpy(
    raw_metrics: dict,
    vertical,
    sizing: GridSizing,
    adiabatic: bool = False,
    hydrostatic: bool = False,
    moist_phys: bool = True,
    part: Optional[RankPart] = None,
):
    """Returns a dict of float64 numpy arrays for every DycoreState field:
    of the whole cube, or of the block `part` (`Partition.part(rank)`)
    holds, equal to the whole cube's cut to it.  The block's halo points
    of u, v and phis take the value the whole cube's halo gather gives
    them: the fields evaluated at the gather's source points.
    `raw_metrics` are the whole cube's terms or a rank's view of them
    (`grid.generation.raw_metric_terms`)."""
    n, h = sizing.n, sizing.halo
    part = part if part is not None else RankPart.whole(n, h)
    ak = np.asarray(vertical.ak)
    bk = np.asarray(vertical.bk)
    ptop = vertical.ptop

    arrays = state_mod.zeros_numpy(sizing, part)

    # pressure setup over the held storage (horizontally uniform; halos
    # then exact)
    arrays["ps"][:] = jw.SURFACE_PRESSURE
    arrays["delp"][:] = initialize_delp(arrays["ps"], ak, bk)
    arrays["pe"][:] = initialize_edge_pressure(arrays["delp"], ptop)
    arrays["peln"][:] = initialize_log_pressure_interfaces(arrays["pe"], ptop)
    arrays["pk"], arrays["pkz"] = initialize_kappa_pressures(
        arrays["pe"], arrays["peln"], ptop
    )
    eta, eta_v = jw.compute_eta(ak, bk)
    at = _Points(raw_metrics["horizontal"], eta_v)

    # --- u and v on their compute points and at their halo sources ---------
    # a halo point takes the source's value of the source component times
    # the sign; a source outside that component's compute points holds 0
    for name, (st, si, sj, sc, sg) in zip(
            ("u", "v"), part.vector_sources("y_iface", "x_iface")):
        out = arrays[name]
        for comp, stagger, fn in ((0, "y_iface", at.u), (1, "x_iface", at.v)):
            pts = (sc == comp) & is_compute(stagger, n, h, si, sj)
            out[pts] = fn(st[pts], si[pts], sj[pts])
        arrays[name] = out * sg[..., None]

    # --- temperature and surface geopotential ------------------------------
    c = part.compute("center")
    ct, ci, cj = (a[c] for a in part.indices())
    lat_a = raw_metrics["horizontal"]["lat_agrid"][ct, ci, cj]
    t_mean = jw.horizontally_averaged_temperature(eta)
    pt = at.cell_average(jw.temperature, [eta, eta_v, t_mean], ct, ci, cj)
    st, si, sj = part.scalar_sources("center")
    pts = is_compute("center", n, h, si, sj)
    arrays["phis"][:] = 1.0e25
    arrays["phis"][pts] = at.cell_average(
        jw.surface_geopotential_perturbation, [], st[pts], si[pts], sj[pts])

    delp, peln = arrays["delp"][c], arrays["peln"][c]
    if not hydrostatic:
        arrays["w"][c] = 0.0
        arrays["delz"][c] = constants.RDG * pt * (
            peln[..., 1:] - peln[..., :-1]
        )

    qvapor = arrays["qvapor"][c]
    if not adiabatic:
        qvapor = jw.specific_humidity(delp, peln, lat_a)
        arrays["qvapor"][c] = qvapor
        pt = pt / (1.0 + constants.ZVIR * qvapor)
    arrays["pt"][c] = pt

    # --- p_var: auxiliary hydrostatic pressure fields -----------------------
    arrays["ps"][:] = arrays["pe"][..., -1]
    if ptop < PTOP_MIN:
        ak1 = (constants.KAPPA + 1.0) / constants.KAPPA
        arrays["peln"][..., 0] = arrays["peln"][..., 1] - ak1
    else:
        arrays["peln"][..., 0] = np.log(ptop)
    peln = arrays["peln"][c]
    if not hydrostatic:
        arrays["delz"][c] = constants.RDG * pt * (
            peln[..., 1:] - peln[..., :-1]
        )
    delz = arrays["delz"][c]
    with np.errstate(divide="ignore", invalid="ignore"):
        if moist_phys:
            pkz = np.exp(constants.KAPPA * np.log(
                constants.RDG * delp * pt
                * (1.0 + constants.ZVIR * qvapor) / delz
            ))
        else:
            pkz = np.exp(constants.KAPPA * np.log(
                constants.RDG * delp * pt / delz
            ))
    arrays["pkz"][c] = pkz
    return arrays


def init_baroclinic_state(
    sizing: GridSizing,
    adiabatic: bool = False,
    hydrostatic: bool = False,
    moist_phys: bool = True,
    *,
    device="cuda",
    dtype=torch.float32,
    part: Optional[RankPart] = None,
):
    """Build a DycoreState with the J&W baroclinic wave: of the whole cube,
    or of one rank's block (`part`, `Partition.part(rank)`), which is all
    that is built, from the metric terms at its points and its halo's
    sources alone."""
    from pace_torch.grid import eta as eta_mod
    from pace_torch.grid.generation import raw_metric_terms

    raw = raw_metric_terms(sizing.n, sizing.halo, part)
    vertical = eta_mod.set_hybrid_pressure_coefficients(sizing.nz)
    arrays = init_baroclinic_state_numpy(
        raw, vertical, sizing, adiabatic, hydrostatic, moist_phys, part
    )
    return state_mod.DycoreState.from_numpy(arrays, device, dtype)
