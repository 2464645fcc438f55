"""Halo-exchange, grid-generation and init-case translate cases.

The port's counterpart of `pace_tpu.utils.translate_cases_grid`, mirroring
the reference's parallel savepoint classes:
- translate_haloupdate.py (HaloUpdate, HaloUpdate_2, MPPUpdateDomains,
  HaloVectorUpdate, MPPBoundaryAdjust), through the port's topology-table
  halo exchange;
- translate_grid.py (GnomonicGrids, MirrorGrid, GridAreas, GridGrid,
  DxDy, AGrid, InitGrid, SetEta, UtilVectors, TrigSg, AAMCorrection,
  DerivedTrig, DivgDel6, InitCubedtoLatLon, EdgeFactors, InitGridUtils),
  read from the port's GridData (grid/generation.py's metric terms);
- translate_init_case.py (InitCase, InitPreJab, JablonowskiBaroclinic,
  PVarAuxiliaryPressureVars), the analytic baroclinic initial condition
  of the port's init.
"""

from __future__ import annotations

import numpy as np
import torch

from pace_torch.parallel.topology import get_topology
from pace_torch.utils.host import as_numpy
from pace_torch.utils.translate import VarSpec
from pace_torch.utils.translate_cases import (
    BaseOpCase,
    _ptop,
    _TracersMixin,
    register,
)

# ---------------------------------------------------------------------------
# halo-update savepoints (reference translate_haloupdate.py)
# ---------------------------------------------------------------------------


@register("HaloUpdate")
class TranslateHaloUpdate(BaseOpCase):
    """reference TranslateHaloUpdate: 'array' (air_temperature,
    3-deep halo) -> scalar halo update."""

    var = "array"
    stagger_kind = "center"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {self.var: VarSpec()}
        self.out_vars = {self.var: VarSpec()}

    def _field(self, s1):
        return s1["pt"]

    def make_inputs(self, s0, s1, gd):
        return {self.var: self._field(s1)}

    def run(self, t):
        from pace_torch.parallel import halo

        spec = get_topology(self.n, self.h).scalar_spec(self.stagger_kind)
        return {self.var: halo.halo_update_scalar(t[self.var], spec)}


@register("HaloUpdate_2")
class TranslateHaloUpdate2(TranslateHaloUpdate):
    """reference TranslateHaloUpdate_2: 'array2'
    (height_on_interface_levels, nz+1 levels)."""

    var = "array2"

    def _field(self, s1):
        zh = s1["pt"]
        return np.concatenate([zh, zh[..., -1:]], -1)


@register("MPPUpdateDomains")
class TranslateMPPUpdateDomains(TranslateHaloUpdate):
    """reference TranslateMPPUpdateDomains: 'update_arr'
    (z_wind_as_tendency_of_pressure)."""

    var = "update_arr"

    def _field(self, s1):
        return s1["omga"]


@register("HaloVectorUpdate")
class TranslateHaloVectorUpdate(BaseOpCase):
    """reference TranslateHaloVectorUpdate: C-grid wind pair halo
    update with cross-edge rotation."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"array_u": VarSpec(), "array_v": VarSpec()}
        self.out_vars = {"array_u": VarSpec(), "array_v": VarSpec()}
        self.stagger = {"array_u": (1, 0), "array_v": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        return {"array_u": s1["uc"], "array_v": s1["vc"]}

    def run(self, t):
        from pace_torch.parallel import halo

        u, v = halo.halo_update_vector(
            get_topology(self.n, self.h), t["array_u"], t["array_v"],
            "x_iface", "y_iface")
        return {"array_u": u, "array_v": v}


@register("MPPBoundaryAdjust")
class TranslateMPPBoundaryAdjust(BaseOpCase):
    """reference TranslateMPPBoundaryAdjust: D-grid wind interface-
    edge synchronization (edge-shared points agree across tiles)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"u": VarSpec(), "v": VarSpec()}
        self.out_vars = {"u": VarSpec(), "v": VarSpec()}
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        return {"u": s1["u"], "v": s1["v"]}

    def run(self, t):
        from pace_torch.parallel import halo

        u, v = halo.synchronize_vector_interfaces(
            get_topology(self.n, self.h), t["u"], t["v"], "y_iface",
            "x_iface")
        return {"u": u, "v": v}


# ---------------------------------------------------------------------------
# grid-generation savepoints (reference translate_grid.py).  The outputs
# are the port's GridData fields; the serialized inputs are write storages
# or upstream fields the regeneration does not need, so they pass through.
# ---------------------------------------------------------------------------

# the namelist scalars some grid savepoints carry
_GRID_SCALARS = {
    "ndims": lambda case, gd: 2, "nregions": lambda case, gd: 6,
    "master_ng": lambda case, gd: case.h,
    "master_npx": lambda case, gd: case.n + 1,
    "master_npy": lambda case, gd: case.n + 1,
    "grid_name": lambda case, gd: 0, "sw_corner": lambda case, gd: 1,
    "se_corner": lambda case, gd: 1, "nw_corner": lambda case, gd: 1,
    "ne_corner": lambda case, gd: 1,
    "npz": lambda case, gd: case.sizing.nz,
    "ptop": lambda case, gd: _ptop(gd),
}


class _GridCase(BaseOpCase):
    """Grid savepoints share f64 metric-term tolerances (reference
    translate_grid.py max_error 1e-13..3e-12 per class)."""

    max_error = 3e-12

    def _hz(self):
        return self.gd.horizontal

    def make_inputs(self, s0, s1, gd):
        out = {}
        for name, spec in self.in_vars.items():
            if name in _GRID_SCALARS:
                out[name] = _GRID_SCALARS[name](self, gd)
            elif spec.column:
                out[name] = as_numpy(getattr(gd.vertical, name, np.zeros(
                    self.sizing.nz)))
            else:
                out[name] = as_numpy(self._grid_field(name))
        return out

    def _grid_field(self, name):
        hz, ang, dmp = (self.gd.horizontal, self.gd.angle,
                        self.gd.damping)
        if name in ("grid", "gridvar", "master_grid_global"):
            return torch.stack([hz.lon, hz.lat], -1)
        if name == "agrid":
            return torch.stack([hz.lon_agrid, hz.lat_agrid], -1)
        if name.startswith("cos_sg"):
            return ang.cos_sg[..., int(name[-1]) - 1]
        if name.startswith("sin_sg"):
            return ang.sin_sg[..., int(name[-1]) - 1]
        for bundle in (hz, ang, dmp):
            if hasattr(bundle, name):
                return getattr(bundle, name)
        raise KeyError(name)

    def run(self, t):
        return {name: self._grid_field(name) for name in self.out_vars}


@register("GnomonicGrids")
class TranslateGnomonicGrids(_GridCase):
    """reference TranslateGnomonicGrids: the gnomonic corner grid
    (max_error 2e-14)."""

    max_error = 2e-14

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"lon": VarSpec(), "lat": VarSpec()}
        self.out_vars = {"lon": VarSpec(), "lat": VarSpec()}
        self.stagger = {"lon": (1, 1), "lat": (1, 1)}

    def _grid_field(self, name):
        return getattr(self.gd.horizontal, name)


@register("MirrorGrid")
class TranslateMirrorGrid(_GridCase):
    """reference TranslateMirrorGrid: tile-1 grid mirrored onto tiles
    2-6 with parity flips (our generation mirrors during
    construction, so the recomputed global corners are returned)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "master_grid_global": VarSpec(),
            "master_ng": VarSpec(), "master_npx": VarSpec(),
            "master_npy": VarSpec(),
        }
        self.out_vars = {"master_grid_global": VarSpec()}
        self.stagger = {"master_grid_global": (1, 1)}


@register("GridAreas")
class TranslateGridAreas(_GridCase):
    """reference TranslateGridAreas (max_error 1e-10, near_zero on
    agrid/dxc/dyc)."""

    max_error = 1e-10
    near_zero = 3e-14
    ignore_near_zero_errors = ("agrid", "dxc", "dyc")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"grid": VarSpec(), "agrid": VarSpec()}
        self.out_vars = {
            name: VarSpec() for name in
            ("area", "area_c", "dxa", "dya", "dxc", "dyc")
        }
        self.stagger = {
            "grid": (1, 1), "area_c": (1, 1), "dxc": (1, 0),
            "dyc": (0, 1),
        }


@register("GridGrid")
class TranslateGridGrid(_GridCase):
    """reference TranslateGridGrid (max_error 1e-14): the halo-filled
    corner lon/lat pair."""

    max_error = 1e-13  # reference uses 1e-13 with near-zero ignores
    near_zero = 1e-14
    ignore_near_zero_errors = ("grid",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"grid": VarSpec()}
        self.out_vars = {"grid": VarSpec()}
        self.stagger = {"grid": (1, 1)}


@register("DxDy")
class TranslateDxDy(_GridCase):
    """reference TranslateDxDy (max_error 3e-14)."""

    max_error = 3e-14

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"grid": VarSpec()}
        self.out_vars = {"dx": VarSpec(), "dy": VarSpec()}
        self.stagger = {"grid": (1, 1), "dx": (0, 1), "dy": (1, 0)}


@register("AGrid")
class TranslateAGrid(_GridCase):
    """reference TranslateAGrid (max_error 1e-13): cell centers from
    corners + corner halo fill."""

    max_error = 1e-13

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"agrid": VarSpec(), "grid": VarSpec()}
        self.out_vars = {"agrid": VarSpec(), "grid": VarSpec()}
        self.stagger = {"grid": (1, 1)}


@register("InitGrid")
class TranslateInitGrid(_GridCase):
    """reference TranslateInitGrid (max_error 3e-12): the full grid
    init — corners, centers, areas."""

    near_zero = 3e-14
    ignore_near_zero_errors = ("gridvar", "agrid")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec() for name in
            ("ndims", "nregions", "grid_name", "sw_corner", "se_corner",
             "nw_corner", "ne_corner")
        }
        self.out_vars = {
            "gridvar": VarSpec(), "agrid": VarSpec(),
            "area": VarSpec(), "area_c": VarSpec(),
        }
        self.stagger = {"gridvar": (1, 1), "area_c": (1, 1)}


@register("SetEta")
class TranslateSetEta(_GridCase):
    """reference TranslateSetEta: hybrid-pressure ak/bk tables +
    ptop for the configured npz."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "npz": VarSpec(), "ptop": VarSpec(),
            "ak": VarSpec(column=True), "bk": VarSpec(column=True),
        }
        self.out_vars = {
            "ptop": VarSpec(column=True),
            "ak": VarSpec(column=True), "bk": VarSpec(column=True),
        }

    def make_inputs(self, s0, s1, gd):
        nzi = self.sizing.nz + 1
        return {
            "npz": self.sizing.nz,
            "ptop": _ptop(gd),
            "ak": np.zeros(nzi), "bk": np.zeros(nzi),
        }

    def run(self, t):
        from pace_torch.grid.eta import set_hybrid_pressure_coefficients

        coeffs = set_hybrid_pressure_coefficients(int(t["npz"]))
        return {
            "ptop": np.float64(coeffs.ptop),
            "ak": np.asarray(coeffs.ak, np.float64),
            "bk": np.asarray(coeffs.bk, np.float64),
        }


@register("UtilVectors")
class TranslateUtilVectors(_GridCase):
    """reference TranslateUtilVectors (max_error 3e-12): the unit
    vectors at centers/edges."""

    near_zero = 1e-13
    ignore_near_zero_errors = ("ec1", "ec2", "ew1", "ew2", "es1", "es2")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        names = ("ec1", "ec2", "ew1", "ew2", "es1", "es2")
        self.in_vars = {n: VarSpec() for n in names}
        self.out_vars = {n: VarSpec() for n in names}
        self.stagger = {"ew1": (1, 0), "ew2": (1, 0),
                        "es1": (0, 1), "es2": (0, 1)}


@register("TrigSg")
class TranslateTrigSg(_GridCase):
    """reference TranslateTrigSg (max_error 2.5e-10): the 9-point
    supergrid trig fields, serialized per point."""

    max_error = 2.5e-10
    near_zero = 1e-14
    ignore_near_zero_errors = tuple(
        f"{k}{i}" for k in ("cos_sg", "sin_sg") for i in range(1, 10))

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        names = tuple(f"cos_sg{i}" for i in range(1, 10)) + tuple(
            f"sin_sg{i}" for i in range(1, 10))
        self.in_vars = {"ec1": VarSpec(), "ec2": VarSpec()}
        self.out_vars = {n: VarSpec() for n in names}


@register("AAMCorrection")
class TranslateAAMCorrection(_GridCase):
    """reference TranslateAAMCorrection (max_error 1e-14, tiny values
    -> near-zero ignored)."""

    max_error = 1e-14
    near_zero = 1e-14
    ignore_near_zero_errors = ("l2c_u", "l2c_v")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"grid": VarSpec()}
        self.out_vars = {"l2c_u": VarSpec(), "l2c_v": VarSpec()}
        self.stagger = {"grid": (1, 1), "l2c_u": (0, 1),
                        "l2c_v": (1, 0)}


@register("DerivedTrig")
class TranslateDerivedTrig(_GridCase):
    """reference TranslateDerivedTrig (max_error 8.5e-14): cosa/sina
    and their staggered/reciprocal forms."""

    max_error = 8.5e-14
    near_zero = 3e-14
    ignore_near_zero_errors = ("cosa", "cosa_u", "cosa_v", "cosa_s")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        names = ("cosa", "sina", "cosa_u", "cosa_v", "cosa_s",
                 "sina_u", "sina_v", "rsin_u", "rsin_v", "rsina",
                 "rsin2")
        self.in_vars = {"grid": VarSpec()}
        self.out_vars = {n: VarSpec() for n in names}
        self.stagger = {
            "grid": (1, 1), "cosa": (1, 1), "sina": (1, 1),
            "rsina": (1, 1), "cosa_u": (1, 0), "sina_u": (1, 0),
            "rsin_u": (1, 0), "cosa_v": (0, 1), "sina_v": (0, 1),
            "rsin_v": (0, 1),
        }


@register("DivgDel6")
class TranslateDivgDel6(_GridCase):
    """reference TranslateDivgDel6: divergence-damping and del-6
    weights."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        names = ("divg_u", "divg_v", "del6_u", "del6_v")
        self.in_vars = {"grid": VarSpec()}
        self.out_vars = {n: VarSpec() for n in names}
        self.stagger = {
            "grid": (1, 1), "divg_u": (0, 1), "del6_u": (0, 1),
            "divg_v": (1, 0), "del6_v": (1, 0),
        }


@register("InitCubedtoLatLon")
class TranslateInitCubedtoLatLon(_GridCase):
    """reference TranslateInitCubedtoLatLon: the cubed->latlon wind
    rotation coefficients."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"agrid": VarSpec()}
        self.out_vars = {n: VarSpec()
                         for n in ("a11", "a12", "a21", "a22")}


@register("EdgeFactors")
class TranslateEdgeFactors(_GridCase):
    """reference TranslateEdgeFactors: edge interpolation factors
    (1-D per tile edge)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        names = ("edge_w", "edge_e", "edge_s", "edge_n",
                 "edge_vect_w", "edge_vect_e", "edge_vect_s",
                 "edge_vect_n")
        self.in_vars = {"grid": VarSpec(), "agrid": VarSpec()}
        self.out_vars = {n: VarSpec(no_j=True) for n in names}
        self.stagger = {"grid": (1, 1)}


@register("InitGridUtils")
class TranslateInitGridUtils(_GridCase):
    """reference TranslateInitGridUtils: the derived grid utilities;
    validated here through the global damping-scale extrema (the
    reference's allreduce(min/max) results) plus rarea."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"grid": VarSpec(), "agrid": VarSpec()}
        self.out_vars = {
            "da_min": VarSpec(column=True),
            "da_max": VarSpec(column=True),
            "da_min_c": VarSpec(column=True),
            "da_max_c": VarSpec(column=True),
            "rarea": VarSpec(),
        }

    def run(self, t):
        dmp = self.gd.damping
        return {
            "da_min": np.float64(dmp.da_min),
            "da_max": np.float64(dmp.da_max),
            "da_min_c": np.float64(dmp.da_min_c),
            "da_max_c": np.float64(dmp.da_max_c),
            "rarea": self.gd.horizontal.rarea,
        }


# ---------------------------------------------------------------------------
# init-case savepoints (reference translate_init_case.py)
# ---------------------------------------------------------------------------


def _baroclinic(case):
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state

    return init_baroclinic_state(case.sizing, device=case.device,
                                 dtype=case.torch_dtype)


@register("InitCase")
class TranslateInitCase(BaseOpCase, _TracersMixin):
    """reference TranslateInitCase: the full analytic baroclinic
    initial state (max_error 6e-14; u/v near-zero ignored)."""

    max_error = 6e-14
    near_zero = 2e-13
    ignore_near_zero_errors = ("u", "v")
    FIELDS = ("u", "v", "uc", "vc", "ua", "va", "w", "pt", "delp", "phis",
              "delz", "ps", "pe", "peln", "pk", "pkz")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {"ptop": VarSpec()}
        self.out_vars = {
            name: VarSpec() for name in
            ("u", "v", "uc", "vc", "ua", "va", "w", "pt", "delp",
             "q4d", "phis", "delz", "ps")
        }
        self.out_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1,
                                      kaxis=1)
        self.out_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.out_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.out_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
        }

    def make_inputs(self, s0, s1, gd):
        return {"ptop": _ptop(gd)}

    def run(self, t):
        state = _baroclinic(self)
        out = {name: getattr(state, name) for name in self.FIELDS}
        out["q4d"] = torch.stack(
            [getattr(state, name) for name in self.TRACERS], -1)
        return out


@register("InitPreJab")
class TranslateInitPreJab(BaseOpCase):
    """reference TranslateInitPreJab: the pressure setup preceding the
    Jablonowski wind/temperature fields (delp from ak/bk, edge
    pressures)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "ak": VarSpec(column=True), "bk": VarSpec(column=True),
            "delp": VarSpec(), "ptop": VarSpec(),
        }
        self.out_vars = {
            "delp": VarSpec(), "ps": VarSpec(),
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
        }

    def make_inputs(self, s0, s1, gd):
        return {
            "ak": as_numpy(gd.vertical.ak).astype(np.float64),
            "bk": as_numpy(gd.vertical.bk).astype(np.float64),
            "delp": np.zeros(s1["pt"].shape),
            "ptop": _ptop(gd),
        }

    def run(self, t):
        from pace_torch.models.fv3.init.baroclinic import (
            initialize_delp,
            initialize_edge_pressure,
        )

        ps = torch.full(t["delp"].shape[:3], 1.0e5, dtype=torch.float64,
                        device=self.device)
        delp = initialize_delp(ps, *(self.tensor(t[k]).double()
                                     for k in ("ak", "bk")))
        pe = initialize_edge_pressure(as_numpy(delp), float(t["ptop"]))
        return {"delp": delp, "ps": ps, "pe": pe}


@register("JablonowskiBaroclinic")
class TranslateJablonowskiBaroclinic(BaseOpCase):
    """reference TranslateJablonowskiBaroclinic (max_error 1e-13,
    u/v near-zero ignored): the analytic wind/temperature fields."""

    max_error = 1e-13
    near_zero = 2e-13
    ignore_near_zero_errors = ("u", "v")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "delp": VarSpec(),
            "eta_v": VarSpec(column=True),
            "eta": VarSpec(column=True),
            "peln": VarSpec(istart=h, jstart=h, kaxis=1),
            "ptop": VarSpec(),
        }
        self.out_vars = {
            name: VarSpec() for name in
            ("u", "v", "w", "pt", "phis", "delz", "qvapor")
        }
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        return {
            "delp": s1["delp"],
            "eta_v": np.zeros(self.sizing.nz),
            "eta": np.zeros(self.sizing.nz),
            "peln": s1["peln"],
            "ptop": _ptop(gd),
        }

    def run(self, t):
        state = _baroclinic(self)
        return {name: getattr(state, name) for name in self.out_vars}


@register("PVarAuxiliaryPressureVars")
class TranslatePVarAuxiliaryPressureVars(BaseOpCase):
    """reference TranslatePVarAuxiliaryPressureVars: p_var's derived
    pressure fields (pe/peln from delp, delz from virtual T)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "delp": VarSpec(), "delz": VarSpec(), "pt": VarSpec(),
            "ps": VarSpec(), "qvapor": VarSpec(),
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
            "peln": VarSpec(istart=h, jstart=h, kaxis=1),
            "pkz": VarSpec(istart=h, jstart=h),
            "ptop": VarSpec(),
        }
        self.out_vars = {
            "delz": VarSpec(), "delp": VarSpec(), "ps": VarSpec(),
            "peln": VarSpec(istart=h, jstart=h, kaxis=1),
        }

    def make_inputs(self, s0, s1, gd):
        return {
            "delp": s1["delp"], "delz": s1["delz"], "pt": s1["pt"],
            "ps": s1["ps"], "qvapor": s1["qvapor"], "pe": s1["pe"],
            "peln": s1["peln"], "pkz": s1["pkz"], "ptop": _ptop(gd),
        }

    def run(self, t):
        from pace_torch.models.fv3.init.baroclinic import (
            initialize_edge_pressure,
            initialize_log_pressure_interfaces,
        )
        from pace_torch.utils import constants as con

        ptop = float(t["ptop"])
        pe = initialize_edge_pressure(as_numpy(t["delp"]), ptop)
        peln = self.tensor(initialize_log_pressure_interfaces(pe, ptop))
        # delz from hydrostatic balance with virtual temperature
        tv = t["pt"] * (1.0 + con.ZVIR * t["qvapor"])
        delz = (con.RDGAS / con.GRAV) * tv * (peln[..., :-1] - peln[..., 1:])
        return {"delz": delz, "delp": t["delp"], "ps": pe[..., -1],
                "peln": peln}
