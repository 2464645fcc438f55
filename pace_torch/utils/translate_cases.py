"""Translate cases: reference savepoint names -> pace_torch ops.

The port's counterpart of `pace_tpu.utils.translate_cases`: every dycore
case of the reference package's registry, with the same savepoint name,
serialized variable names, layout offsets (translate.py VarSpec), write
staggers and thresholds, whose `run` calls the port's op.  The grid, halo
and init cases are in `translate_cases_grid`, the physics and coupler
cases in `translate_cases_physics`; importing this package's
`translate_cases_grid` and `translate_cases_physics` fills `CASES` with
all of them.

A case is built on a device (the card unless the caller asks for the
CPU): `compute` moves the assembled numpy inputs there once, as tensors of
the case's dtype, and brings the outputs back to the host with one copy
per dtype, so `validate` compares numpy as the reference does.  Per-level
column inputs (VarSpec.column) stay numpy: the ops take them as
parameters.

No serialized Fortran data ships in the repository, so each case also has
`make_inputs(s0, s1, gd)`: global inputs built from the C12 baroclinic
state s0 and the state after one step s1 ({name: numpy array}, see
`state_arrays`), the same arrays the reference package's cases and tests
build, for writing savepoints of the model itself
(`translate.write_case_savepoint`).  Real Serialbox files are read by the
same cases.
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np
import torch

from pace_torch.models.fv3.config import (
    DynamicalCoreConfig,
    get_column_namelist,
)
from pace_torch.parallel.topology import get_topology
from pace_torch.utils.gridtools import Domain
from pace_torch.utils.host import as_numpy, to_host
from pace_torch.utils.translate import TranslateCase, VarSpec

# registry: savepoint name -> case class (reference conftest collection)
CASES: Dict[str, Type["BaseOpCase"]] = {}

# the DycoreState fields the input builders read, as state_arrays gives them
STATE_FIELDS = ("u", "v", "w", "delp", "pt", "delz", "qvapor", "qliquid",
                "qice", "qrain", "qsnow", "qgraupel", "qcld", "ps", "pe",
                "pk", "peln", "pkz", "phis", "q_con", "omga", "ua", "va",
                "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd")

_NUMPY_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def register(name):
    def deco(cls):
        cls.savepoint_name = name
        CASES[name] = cls
        return cls

    return deco


def state_arrays(state) -> Dict[str, np.ndarray]:
    """{field: float64 numpy array} of a DycoreState's STATE_FIELDS, the
    s0/s1 that `make_inputs` takes."""
    host = to_host({f: getattr(state, f) for f in STATE_FIELDS})
    return {f: np.asarray(a, np.float64) for f, a in host.items()}


class BaseOpCase(TranslateCase):
    """TranslateCase bound to the port's grid data and dycore config on
    `device` (where `grid_data` lives).  Subclasses implement
    `run(t) -> {name: tensor or array}` on the inputs as tensors (scalars
    and column inputs as they were read)."""

    def __init__(self, sizing, grid_data, config: DynamicalCoreConfig = None,
                 dtype=torch.float64, layout=(1, 1), device="cuda"):
        super().__init__(sizing, dtype=_NUMPY_DTYPE[dtype], layout=layout)
        self.gd = grid_data
        self.config = config or DynamicalCoreConfig(do_sat_adj=False)
        self.n = sizing.n
        self.h = sizing.halo
        self.dom = Domain.whole(sizing.n, sizing.halo)
        self.device = torch.device(device)
        self.torch_dtype = dtype

    def tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=self.torch_dtype,
                               device=self.device)

    def compute(self, inputs: Dict) -> Dict[str, np.ndarray]:
        t = {}
        for name, value in inputs.items():
            spec = self.in_vars.get(name)
            keep = np.ndim(value) == 0 or (spec is not None and spec.column)
            t[name] = value if keep else self.tensor(value)
        return to_host(self.run(t))

    def run(self, t: Dict) -> Dict:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# helpers of the input builders
# ---------------------------------------------------------------------------


def smooth_field(shape, seed, scale=1.0):
    """Horizontally smoothed random field (PPM limiters need sane data)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape)
    for ax in (1, 2):
        if a.shape[ax] >= 3:
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
    return scale * a


def gz_from_delz(phis, delz):
    """Interface heights consistent with layer thicknesses."""
    zs = phis / 9.80665
    below = np.cumsum(delz[..., ::-1], -1)[..., ::-1]
    return np.concatenate([zs[..., None] - below, zs[..., None]], -1)


def _col(sizing, value_top, value_rest):
    """Per-k column with a distinct sponge-top value (nord_col shape)."""
    c = np.full(sizing.nz, float(value_rest))
    c[:3] = value_top
    return c


def _ptop(gd) -> float:
    return float(as_numpy(gd.vertical.ptop))


def _dp_ref(gd) -> np.ndarray:
    """The reference pressure thickness of each level, ak + bk * 1e5."""
    ph = (as_numpy(gd.vertical.ak).astype(np.float64)
          + as_numpy(gd.vertical.bk).astype(np.float64) * 1.0e5)
    return ph[1:] - ph[:-1], ph


class _TracersMixin:
    TRACERS = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel",
               "qcld")


# ---------------------------------------------------------------------------
# per-operator cases
# ---------------------------------------------------------------------------


@register("XPPM")
class TranslateXPPM(BaseOpCase):
    """reference translate_xppm.py TranslateXPPM: q (serial 'qx'),
    c (serial 'cx', compute-i), param iord -> xflux."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "q": VarSpec(serialname="qx"),
            "c": VarSpec(serialname="cx", istart=h),
            "iord": VarSpec(),
        }
        self.out_vars = {"xflux": VarSpec(istart=h, jstart=h)}
        self.stagger = {"c": (1, 0), "xflux": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        return {"q": s1["pt"], "c": smooth_field(s1["pt"].shape, 1, 0.2),
                "iord": 8}

    def run(self, t):
        from pace_torch.ops.xppm import x_flux

        return {"xflux": x_flux(t["q"], t["c"],
                                self.gd.horizontal.dxa[..., None],
                                self.dom, int(t["iord"]))}


@register("FvTp2d")
class TranslateFvTp2d(BaseOpCase):
    """reference translate_fvtp2d.py TranslateFvTp2d: q/crx/cry/xfx/yfx/
    mfx/mfy + hord -> q passthrough and the mass fluxes fx/fy (the
    transport kernel, K-T, on the card)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "q": VarSpec(),
            "crx": VarSpec(istart=h),
            "cry": VarSpec(jstart=h),
            "x_area_flux": VarSpec(serialname="xfx", istart=h),
            "y_area_flux": VarSpec(serialname="yfx", jstart=h),
            "x_mass_flux": VarSpec(serialname="mfx", istart=h, jstart=h),
            "y_mass_flux": VarSpec(serialname="mfy", istart=h, jstart=h),
            "hord": VarSpec(),
        }
        self.out_vars = {
            "q": VarSpec(),
            "q_x_flux": VarSpec(serialname="fx", istart=h, jstart=h),
            "q_y_flux": VarSpec(serialname="fy", istart=h, jstart=h),
        }
        self.stagger = {
            "crx": (1, 0), "x_area_flux": (1, 0), "x_mass_flux": (1, 0),
            "cry": (0, 1), "y_area_flux": (0, 1), "y_mass_flux": (0, 1),
            "q_x_flux": (1, 0), "q_y_flux": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "q": s1["pt"],
            "crx": smooth_field(shape3, 2, 0.2),
            "cry": smooth_field(shape3, 3, 0.2),
            "x_area_flux": smooth_field(shape3, 4, 1e7),
            "y_area_flux": smooth_field(shape3, 5, 1e7),
            "x_mass_flux": smooth_field(shape3, 6, 1e9),
            "y_mass_flux": smooth_field(shape3, 7, 1e9),
            "hord": 6,
        }

    def run(self, t):
        from pace_torch.ops.fvtp2d import fv_tp_2d

        fx, fy = fv_tp_2d(
            t["q"], t["crx"], t["cry"], t["x_area_flux"], t["y_area_flux"],
            self.gd, self.dom, int(t["hord"]),
            x_mass_flux=t.get("x_mass_flux"),
            y_mass_flux=t.get("y_mass_flux"),
        )
        return {"q": t["q"], "q_x_flux": fx, "q_y_flux": fy}


@register("C_SW")
class TranslateC_SW(BaseOpCase):
    """reference translate_c_sw.py TranslateC_SW: every variable is
    serialized with a 'd' suffix (delpd, ptd, ...); outputs add
    delpcd/ptcd.  max_error 2e-10 matches the reference setting."""

    max_error = 2e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec(serialname=name + "d")
            for name in ("delp", "pt", "u", "v", "w", "uc", "vc",
                         "ua", "va", "ut", "vt", "divgd")
        }
        self.in_vars["omga"] = VarSpec(serialname="omgad")
        self.in_vars["dt2"] = VarSpec()
        self.out_vars = {
            name: VarSpec(serialname=name + "d")
            for name in ("delp", "pt", "uc", "vc", "ua", "va", "ut",
                         "vt", "divgd", "w")
        }
        self.out_vars["delpc"] = VarSpec(serialname="delpcd")
        self.out_vars["ptc"] = VarSpec(serialname="ptcd")
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
            "divgd": (1, 1),
        }

    def make_inputs(self, s0, s1, gd):
        zero3 = np.zeros(s1["pt"].shape)
        return {
            "delp": s1["delp"], "pt": s1["pt"], "u": s1["u"],
            "v": s1["v"], "w": s1["w"], "uc": s1["uc"], "vc": s1["vc"],
            "ua": s1["ua"], "va": s1["va"], "ut": zero3, "vt": zero3,
            "omga": s1["omga"], "divgd": zero3, "dt2": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.c_sw import c_sw

        (delpc, ptc, uc, vc, ua, va, ut, vt, divgd, _omga, delp_f, pt_f,
         w_f) = c_sw(t["delp"], t["pt"], t["u"], t["v"], t["w"], t["omga"],
                     self.gd, self.dom, float(t["dt2"]),
                     self.config.nord)
        return {"delp": delp_f, "pt": pt_f, "w": w_f, "uc": uc, "vc": vc,
                "ua": ua, "va": va, "ut": ut, "vt": vt, "divgd": divgd,
                "delpc": delpc, "ptc": ptc}


@register("D_SW")
class TranslateD_SW(BaseOpCase):
    """reference translate_d_sw.py TranslateD_SW ('d'-suffixed serial
    names, dt parameter; max_error 3.2e-10).  xfx/crx/yfx/cry are
    derived from uc/vc inside d_sw (fx_adv), matching the reference
    __call__."""

    max_error = 3.2e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            name: VarSpec(serialname=name + "d")
            for name in ("uc", "vc", "w", "delpc", "delp", "u", "v",
                         "heat_source", "diss_est", "q_con", "pt",
                         "ua", "va", "divgd")
        }
        for name in ("mfx", "cx", "mfy", "cy"):
            self.in_vars[name] = VarSpec(serialname=name + "d",
                                         istart=h, jstart=h)
        # storages the reference does not serialize for D_SW (zero when
        # absent), and zh, which rides its own UpdateDzD savepoint
        self.in_vars["ut"] = VarSpec(serialname="utd", optional=True)
        self.in_vars["vt"] = VarSpec(serialname="vtd", optional=True)
        self.in_vars["zh"] = VarSpec(serialname="zhd", optional=True)
        self.in_vars["dt"] = VarSpec()
        out_names = ("uc", "vc", "w", "delpc", "delp", "u", "v",
                     "heat_source", "diss_est", "q_con", "pt", "divgd")
        self.out_vars = {
            name: VarSpec(serialname=name + "d") for name in out_names
        }
        for name in ("mfx", "cx", "mfy", "cy", "crx", "xfx"):
            self.out_vars[name] = VarSpec(serialname=name + "d",
                                          istart=h, jstart=h)
        self.out_vars["crx"] = VarSpec(serialname="crxd", istart=h)
        self.out_vars["xfx"] = VarSpec(serialname="xfxd", istart=h)
        self.out_vars["cry"] = VarSpec(serialname="cryd", jstart=h)
        self.out_vars["yfx"] = VarSpec(serialname="yfxd", jstart=h)
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
            "divgd": (1, 1), "mfx": (1, 0), "cx": (1, 0),
            "mfy": (0, 1), "cy": (0, 1), "crx": (1, 0), "xfx": (1, 0),
            "cry": (0, 1), "yfx": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        zero3 = np.zeros(s1["pt"].shape)
        return {
            "uc": s1["uc"], "vc": s1["vc"], "w": s1["w"],
            "delpc": s1["delp"], "delp": s1["delp"], "u": s1["u"],
            "v": s1["v"], "mfx": zero3, "mfy": zero3, "cx": zero3,
            "cy": zero3, "heat_source": zero3, "diss_est": zero3,
            "q_con": s1["q_con"], "pt": s1["pt"], "ua": s1["ua"],
            "va": s1["va"], "divgd": zero3, "ut": zero3, "vt": zero3,
            "dt": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.d_sw import d_sw

        col = get_column_namelist(self.config, self.sizing.nz)
        zeros = torch.zeros_like(t["pt"])
        out = d_sw(
            t["delp"], t["pt"], t["u"], t["v"], t["w"], t["uc"], t["vc"],
            t["ua"], t["va"], t["divgd"], t["mfx"], t["mfy"], t["cx"],
            t["cy"], t["q_con"], t["heat_source"], t["diss_est"],
            t.get("ut", zeros), t.get("vt", zeros), self.gd, col,
            self.config, self.dom, float(t["dt"]),
        )
        result = {k: v for k, v in out.items() if k in self.out_vars}
        result["delpc"] = out["delpc"]
        # the C-grid winds are inout storages of the reference savepoint,
        # unchanged by the D-grid step
        result["uc"] = t["uc"]
        result["vc"] = t["vc"]
        return result


@register("Riem_Solver_C")
class TranslateRiemSolverC(BaseOpCase):
    """reference translate_riem_solver_c.py: cappa/hs/w3/ptc/q_con/
    delpc/gz/pef/ws + dt2/ptop -> pef, gz (the SIM1 kernel, K-S, on the
    card).  max_error 5e-14."""

    max_error = 5e-14

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec() for name in
            ("cappa", "hs", "w3", "ptc", "q_con", "delpc", "gz", "pef",
             "ws")
        }
        self.in_vars["dt2"] = VarSpec()
        self.in_vars["ptop"] = VarSpec()
        self.out_vars = {"pef": VarSpec(), "gz": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        gz = gz_from_delz(s1["phis"], s1["delz"])
        return {
            "cappa": np.full(s1["pt"].shape, 0.28), "hs": s1["phis"],
            "w3": s1["w"], "ptc": s1["pt"], "q_con": s1["q_con"],
            "delpc": s1["delp"], "gz": gz * 1.0,
            "pef": np.zeros(gz.shape), "ws": np.zeros(s1["ps"].shape),
            "dt2": 112.5, "ptop": _ptop(gd),
        }

    def run(self, t):
        from pace_torch.ops.riemann import riem_solver_c

        gz, pef = riem_solver_c(
            float(t["dt2"]), t["cappa"], float(t["ptop"]), t["hs"],
            t["ws"], t["ptc"], t["q_con"], t["delpc"], t["gz"], t["w3"],
            self.config.p_fac,
        )
        return {"gz": gz, "pef": pef}


@register("Riem_Solver3")
class TranslateRiemSolver3(BaseOpCase):
    """reference translate_riem_solver3.py: the full D-grid vertical
    solver (K-S on the card); pe/peln are serialized (i, k, j)
    (kaxis=1)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            name: VarSpec() for name in
            ("cappa", "zs", "w", "delz", "q_con", "delp", "pt", "zh",
             "ppe", "pk3", "pk")
        }
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["ws"] = VarSpec(serialname="wsd", istart=h, jstart=h)
        for p in ("dt", "ptop", "last_call"):
            self.in_vars[p] = VarSpec()
        self.out_vars = {
            "zh": VarSpec(), "w": VarSpec(),
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
            "peln": VarSpec(istart=h, jstart=h, kaxis=1),
            "ppe": VarSpec(), "delz": VarSpec(),
            "pk": VarSpec(istart=h, jstart=h),
            "pk3": VarSpec(),
        }

    def make_inputs(self, s0, s1, gd):
        zh = gz_from_delz(s1["phis"], s1["delz"])
        return {
            "cappa": np.full(s1["pt"].shape, 0.28),
            "zs": s1["phis"] / 9.80665, "w": s1["w"],
            "delz": s1["delz"], "q_con": s1["q_con"],
            "delp": s1["delp"], "pt": s1["pt"], "zh": zh,
            "pe": s1["pe"], "ppe": np.zeros(s1["pe"].shape),
            "pk3": s1["pk"], "pk": s1["pk"], "peln": s1["peln"],
            "ws": np.zeros(s1["ps"].shape), "dt": 112.5,
            "ptop": _ptop(gd), "last_call": 1,
        }

    def run(self, t):
        from pace_torch.ops.riemann import riem_solver3

        delz, zh, pe, ppe, pk3, pk, peln, w = riem_solver3(
            float(t["dt"]), t["cappa"], float(t["ptop"]), t["zs"],
            t["ws"], t["delz"], t["q_con"], t["delp"], t["pt"], t["zh"],
            t["pe"], t["pk3"], t["pk"], t["peln"], t["w"],
            self.config.p_fac, self.config.beta, self.config.use_logp,
            bool(t["last_call"]),
        )
        return {"delz": delz, "zh": zh, "pe": pe, "ppe": ppe, "pk3": pk3,
                "pk": pk, "peln": peln, "w": w}


@register("UpdateDzD")
class TranslateUpdateDzD(BaseOpCase):
    """reference translate_updatedzd.py: zs/zh/crx/cry/xfx/yfx/wsd + dt
    -> zh, ws.  near_zero 1e-30 and the zh/wsd near-zero tolerance match
    the reference settings."""

    near_zero = 1e-30
    ignore_near_zero_errors = ("height", "ws")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "surface_height": VarSpec(serialname="zs"),
            "height": VarSpec(serialname="zh"),
            "courant_number_x": VarSpec(serialname="crx", istart=h),
            "courant_number_y": VarSpec(serialname="cry", jstart=h),
            "x_area_flux": VarSpec(serialname="xfx", istart=h),
            "y_area_flux": VarSpec(serialname="yfx", jstart=h),
            "ws": VarSpec(serialname="wsd", istart=h, jstart=h),
            "dt": VarSpec(),
        }
        self.out_vars = {
            "height": VarSpec(serialname="zh"),
            "ws": VarSpec(serialname="wsd", istart=h, jstart=h),
        }
        self.stagger = {
            "courant_number_x": (1, 0), "x_area_flux": (1, 0),
            "courant_number_y": (0, 1), "y_area_flux": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "surface_height": s1["phis"] / 9.80665,
            "height": gz_from_delz(s1["phis"], s1["delz"]),
            "courant_number_x": smooth_field(shape3, 8, 0.2),
            "courant_number_y": smooth_field(shape3, 9, 0.2),
            "x_area_flux": smooth_field(shape3, 10, 1e7),
            "y_area_flux": smooth_field(shape3, 11, 1e7),
            "ws": np.zeros(s1["ps"].shape), "dt": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.updatedzd import update_dz_d

        col = get_column_namelist(self.config, self.sizing.nz)
        height, ws = update_dz_d(
            t["surface_height"], t["height"], t["courant_number_x"],
            t["courant_number_y"], t["x_area_flux"], t["y_area_flux"],
            self.gd, col, self.config, self.dom, float(t["dt"]),
            _dp_ref(self.gd)[0],
        )
        return {"height": height, "ws": ws}


@register("NH_P_Grad")
class TranslateNHPGrad(BaseOpCase):
    """reference translate_nh_p_grad.py: u/v/pp/gz/pk3/delp + dt/ptop/
    akap -> updated winds and interface fields.  max_error 5e-10."""

    max_error = 5e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec() for name in
            ("u", "v", "pp", "gz", "pk3", "delp")
        }
        for p in ("dt", "ptop", "akap"):
            self.in_vars[p] = VarSpec()
        self.out_vars = {
            "u": VarSpec(), "v": VarSpec(), "pp": VarSpec(),
            "gz": VarSpec(), "pk3": VarSpec(), "delp": VarSpec(),
        }
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        return {
            "u": s1["u"], "v": s1["v"],
            "pp": smooth_field(s1["pe"].shape, 12, 10.0),
            "gz": gz_from_delz(s1["phis"], s1["delz"]) * 9.80665,
            "pk3": s1["pk"], "delp": s1["delp"],
            "dt": 112.5, "ptop": _ptop(gd), "akap": 2.0 / 7.0,
        }

    def run(self, t):
        from pace_torch.ops.nh_p_grad import nh_p_grad

        u, v, *_ = nh_p_grad(
            t["u"], t["v"], t["pp"], t["gz"], t["pk3"], t["delp"], self.gd,
            self.dom, float(t["dt"]), float(t["ptop"]),
            float(t["akap"]),
        )
        return {"u": u, "v": v, "pp": t["pp"], "gz": t["gz"],
                "pk3": t["pk3"], "delp": t["delp"]}


@register("Tracer2D1L")
class TranslateTracer2D1L(BaseOpCase, _TracersMixin):
    """reference translate_tracer2d1l.py: per-tracer fields (each advected
    tracer its own variable, as the checkpointer savepoints have them) +
    dp1/mfxd/mfyd/cxd/cyd -> advected tracers and the fluxes (K-T on the
    card)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.TRACERS}
        self.in_vars["dp1"] = VarSpec()
        self.in_vars["mfxd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["mfyd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["cxd"] = VarSpec(istart=h)
        self.in_vars["cyd"] = VarSpec(jstart=h)
        self.out_vars = {name: VarSpec() for name in self.TRACERS}
        self.out_vars["mfxd"] = VarSpec(istart=h, jstart=h)
        self.out_vars["mfyd"] = VarSpec(istart=h, jstart=h)
        self.stagger = {
            "mfxd": (1, 0), "cxd": (1, 0), "mfyd": (0, 1), "cyd": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.TRACERS}
        d.update(dp1=s0["delp"], mfxd=s1["mfxd"], mfyd=s1["mfyd"],
                 cxd=s1["cxd"], cyd=s1["cyd"])
        return d

    def run(self, t):
        from pace_torch.ops.tracer_advection import tracer_advection

        out = tracer_advection(
            {name: t[name] for name in self.TRACERS}, t["dp1"], t["mfxd"],
            t["mfyd"], t["cxd"], t["cyd"], self.gd,
            get_topology(self.n, self.h), self.config.hord_tr,
        )
        result = {name: out[name] for name in self.TRACERS}
        result["mfxd"] = t["mfxd"]
        result["mfyd"] = t["mfyd"]
        return result


@register("Fillz")
class TranslateFillZ(BaseOpCase):
    """reference translate_fillz.py TranslateFillz (savepoint name
    "Fillz", translate_fillz.py:12): j-collapsed (i, k) blocks (dp2) and
    (i, k, nq) tracers; max_error 1e-13, near-zero errors ignored for
    the tracers.  The nq tracers are fixed as one stack (K-F on the
    card)."""

    max_error = 1e-13
    ignore_near_zero_errors = ("q2tracers",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "dp2": VarSpec(istart=h, no_j=True),
            "q2tracers": VarSpec(istart=h, no_j=True),
            "nq": VarSpec(),
        }
        self.out_vars = {
            "q2tracers": VarSpec(istart=h, no_j=True),
        }

    def make_inputs(self, s0, s1, gd):
        h = self.h
        qt = np.stack([s1[name][:, :, h, :] for name in
                       _TracersMixin.TRACERS], -1)
        qt[:, h + 2, 5, 0] = -1e-9  # a negative to fix
        return {"dp2": s1["delp"][:, :, h, :], "q2tracers": qt, "nq": 7}

    def run(self, t):
        from pace_torch.ops.fillz import fix_tracers

        qt, nq = t["q2tracers"], int(t["nq"])     # (6, Ni, nz, nq)
        fixed = fix_tracers(qt[..., :nq].movedim(-1, 0).contiguous(),
                            t["dp2"].contiguous())
        out = qt.clone()
        out[..., :nq] = fixed.movedim(0, -1)
        return {"q2tracers": out}


@register("Remapping")
class TranslateRemapping(BaseOpCase, _TracersMixin):
    """reference translate_remapping.py: the full Lagrangian->Eulerian
    vertical remap (K-F on the card).  pe/peln are (i, k, j)-ordered.
    max_error 2e-8 matches the reference."""

    max_error = 2e-8
    near_zero = 3e-18
    ignore_near_zero_errors = ("q_con",) + _TracersMixin.TRACERS

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.TRACERS}
        for name in ("w", "u", "v", "delz", "pt", "delp", "cappa",
                     "q_con", "ps"):
            self.in_vars[name] = VarSpec()
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.in_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.in_vars["hs"] = VarSpec(serialname="phis")
        self.in_vars["wsd"] = VarSpec(istart=h, jstart=h)
        for p in ("ptop", "akap", "zvir", "last_step", "consv_te", "mdt"):
            self.in_vars[p] = VarSpec()
        self.out_vars = {name: VarSpec() for name in self.TRACERS}
        for name in ("pt", "delp", "delz", "q_con", "u", "v", "w", "ps",
                     "cappa"):
            self.out_vars[name] = VarSpec()
        self.out_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.out_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.out_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.out_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.TRACERS}
        for name in ("w", "u", "v", "delz", "pt", "delp", "q_con", "pkz",
                     "pk", "peln", "pe", "ps"):
            d[name] = s1[name]
        d.update(
            cappa=np.full(s1["pt"].shape, 0.28), hs=s1["phis"],
            wsd=np.zeros(s1["ps"].shape), ptop=_ptop(gd),
            akap=2.0 / 7.0, zvir=0.608, last_step=1, consv_te=0.0,
            mdt=225.0,
        )
        return d

    def run(self, t):
        from pace_torch.ops.remapping import lagrangian_to_eulerian

        tracers = {name: t[name] for name in self.TRACERS}
        tracers["qo3mr"] = torch.zeros_like(t["qvapor"])
        tracers["qsgs_tke"] = torch.zeros_like(t["qvapor"])
        out = lagrangian_to_eulerian(
            tracers, t["pt"], t["delp"], t["delz"], t["peln"], t["u"],
            t["v"], t["w"], t["cappa"], t["q_con"], t["pkz"], t["pk"],
            t["pe"], t["hs"], t["ps"], t["wsd"], self.gd, self.config,
            self.n, self.h, bool(t["last_step"]), float(t["consv_te"]),
            float(t["mdt"]),
        )
        result = {name: out["tracers"][name] for name in self.TRACERS}
        for name in ("pt", "delp", "delz", "q_con", "u", "v", "w", "ps",
                     "cappa", "pkz", "pk", "peln", "pe"):
            result[name] = out[name]
        return result


def _dycore_state(t):
    """A DycoreState of the case's tensors, zeros for the fields the
    savepoint does not hold (qo3mr/qsgs_tke at init)."""
    from pace_torch.models.fv3.state import FIELD_METADATA, DycoreState

    zero = torch.zeros_like(t["pt"])
    return DycoreState(**{name: t[name] if name in t else zero.clone()
                          for name in FIELD_METADATA})


@register("FVDynamics")
class TranslateFVDynamics(BaseOpCase):
    """reference translate_fvdynamics.py: the whole dycore step.  In/out
    variables mirror the checkpointer's FVDynamics-In/-Out savepoints
    (fv_dynamics.py:321-341)."""

    max_error = 3e-5  # the reference TranslateDriver coupled tolerance

    FIELDS = ("u", "v", "w", "delp", "pt", "delz", "qvapor", "qliquid",
              "qice", "qrain", "qsnow", "qgraupel", "qcld", "ps", "pe",
              "pk", "peln", "pkz", "phis", "q_con", "omga", "ua", "va",
              "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.FIELDS}
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.in_vars["mfxd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["mfyd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["cxd"] = VarSpec(istart=h)
        self.in_vars["cyd"] = VarSpec(jstart=h)
        self.in_vars["bdt"] = VarSpec()
        self.out_vars = dict(self.in_vars)
        del self.out_vars["bdt"]
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
            "mfxd": (1, 0), "cxd": (1, 0), "mfyd": (0, 1), "cyd": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        return dict(s0, bdt=225.0)

    def run(self, t):
        from pace_torch.models.fv3.dynamics import DynamicalCore

        core = DynamicalCore(self.config, self.sizing, self.gd,
                             timestep=float(t["bdt"]))
        out = core.step_dynamics(_dycore_state(t))
        return {name: getattr(out, name) for name in self.out_vars}


# ---------------------------------------------------------------------------
# the rest of the reference's dycore classes
# (fv3core/tests/savepoint/translate/)
# ---------------------------------------------------------------------------


@register("Del2Cubed")
class TranslateDel2Cubed(BaseOpCase):
    """reference translate_del2cubed.py TranslateDel2Cubed: qdel +
    nmax/cd -> qdel through HyperdiffusionDamping."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "qdel": VarSpec(), "nmax": VarSpec(), "cd": VarSpec(),
        }
        self.out_vars = {"qdel": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        return {"qdel": s1["pt"], "nmax": 3,
                "cd": 0.2 * float(gd.damping.da_min)}

    def run(self, t):
        from pace_torch.ops.del2cubed import hyperdiffusion

        return {"qdel": hyperdiffusion(t["qdel"], self.gd, float(t["cd"]),
                                       self.dom, nmax=int(t["nmax"]))}


@register("DelnFlux")
class TranslateDelnFlux(BaseOpCase):
    """reference translate_delnflux.py TranslateDelnFlux: q/fx/fy +
    per-k damp_c, nord_column columns and optional mass -> damped
    fx/fy (DelnFlux adds del-n damping fluxes to the input fluxes)."""

    has_mass = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "q": VarSpec(),
            "fx": VarSpec(istart=h, jstart=h),
            "fy": VarSpec(istart=h, jstart=h),
            "damp_c": VarSpec(column=True),
            "nord_column": VarSpec(column=True),
        }
        if self.has_mass:
            self.in_vars["mass"] = VarSpec()
        self.out_vars = {
            "fx": VarSpec(istart=h, jstart=h),
            "fy": VarSpec(istart=h, jstart=h),
        }
        self.stagger = {"fx": (1, 0), "fy": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        d = {
            "q": s1["w"],
            "fx": smooth_field(s1["pt"].shape, 21, 1e3),
            "fy": smooth_field(s1["pt"].shape, 22, 1e3),
            "damp_c": _col(self.sizing, 0.2, 0.2),
            "nord_column": _col(self.sizing, 0, 2),
        }
        if self.has_mass:
            d["mass"] = s1["delp"]
        return d

    def run(self, t):
        from pace_torch.ops.delnflux import deln_flux

        fx, fy = deln_flux(
            t["q"], t["fx"], t["fy"], self.gd, np.asarray(t["nord_column"]),
            np.asarray(t["damp_c"]), self.dom, mass=t.get("mass"),
        )
        return {"fx": fx, "fy": fy}


@register("DelnFlux_2")
class TranslateDelnFlux2(TranslateDelnFlux):
    """reference translate_delnflux.py TranslateDelnFlux_2: the
    mass-less variant."""

    has_mass = False


@register("Del6VtFlux")
class TranslateDel6VtFlux(BaseOpCase):
    """reference translate_del6vtflux.py TranslateDel6VtFlux: wq/wd2/
    fx2/fy2 + damp4/nord_w columns -> DelnFluxNoSG fluxes and the
    damped d2 intermediate."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "q": VarSpec(serialname="wq"),
            "d2": VarSpec(serialname="wd2"),
            "fx2": VarSpec(),
            "fy2": VarSpec(),
            "damp_c": VarSpec(serialname="damp4", column=True),
            "nord_w": VarSpec(column=True),
        }
        self.out_vars = {
            "fx2": VarSpec(),
            "fy2": VarSpec(),
            "d2": VarSpec(serialname="wd2"),
            "q": VarSpec(serialname="wq"),
        }
        self.stagger = {"fx2": (1, 0), "fy2": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "q": s1["w"], "d2": np.zeros(shape3),
            "fx2": np.zeros(shape3), "fy2": np.zeros(shape3),
            "damp_c": _col(self.sizing, 0.2, 0.2),
            "nord_w": _col(self.sizing, 0, 1),
        }

    def run(self, t):
        from pace_torch.ops.delnflux import calc_damp, deln_flux_nosg

        nord_col = np.asarray(t["nord_w"])
        damp_col = calc_damp(np.asarray(t["damp_c"]),
                             float(self.gd.damping.da_min), nord_col)
        fx2, fy2, d2 = deln_flux_nosg(
            t["q"], self.gd.damping.del6_u, self.gd.damping.del6_v,
            self.gd.horizontal.rarea, nord_col, np.asarray(damp_col),
            self.dom,
        )
        return {"fx2": fx2, "fy2": fy2, "d2": d2, "q": t["q"]}


@register("DivergenceDamping")
class TranslateDivergenceDamping(BaseOpCase):
    """reference translate_divergencedamping.py: winds + divg_d/delpc/
    ke/vort/wk + nord_col/d2_bg columns + dt -> ke, delpc.  max_error
    1.4e-10 matches the reference."""

    max_error = 1.4e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u": VarSpec(), "v": VarSpec(), "va": VarSpec(),
            "damped_rel_vort_bgrid": VarSpec(serialname="vort"),
            "ua": VarSpec(), "divg_d": VarSpec(), "vc": VarSpec(),
            "uc": VarSpec(), "delpc": VarSpec(), "ke": VarSpec(),
            "rel_vort_agrid": VarSpec(serialname="wk"),
            "nord_col": VarSpec(column=True),
            "d2_bg": VarSpec(column=True),
            "dt": VarSpec(),
        }
        self.out_vars = {"ke": VarSpec(), "delpc": VarSpec()}
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
            "divg_d": (1, 1), "ke": (1, 1),
            "damped_rel_vort_bgrid": (1, 1),
        }

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "u": s1["u"], "v": s1["v"], "va": s1["va"], "ua": s1["ua"],
            "damped_rel_vort_bgrid": np.zeros(shape3),
            "divg_d": smooth_field(shape3, 23, 1e-5),
            "vc": s1["vc"], "uc": s1["uc"], "delpc": s1["delp"],
            "ke": smooth_field(shape3, 24, 1e2),
            "rel_vort_agrid": smooth_field(shape3, 25, 1e-5),
            "nord_col": _col(self.sizing, 0, self.config.nord),
            "d2_bg": _col(self.sizing, 0.015, 0.0),
            "dt": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.divergence_damping import divergence_damping

        c = self.config
        _vort, ke, delpc, _divg_d = divergence_damping(
            t["u"], t["v"], t["va"], t["ua"], t["divg_d"], t["vc"],
            t["uc"], t["ke"], t["rel_vort_agrid"], self.gd, self.dom,
            float(t["dt"]), c.dddmp, c.d4_bg, c.nord,
            np.asarray(t["nord_col"]), np.asarray(t["d2_bg"]),
        )
        return {"ke": ke, "delpc": delpc}


@register("A2B_Ord4")
class TranslateA2BOrd4(BaseOpCase):
    """reference translate_a2b_ord4.py TranslateA2B_Ord4: wk/vort/
    delpc + nord_col + dt; vort <- a2b_ord4(wk) when dddmp >= 1e-5
    (A2B_Ord4Compute wraps DivergenceDamping.a2b_ord4)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "wk": VarSpec(), "vort": VarSpec(), "delpc": VarSpec(),
            "nord_col": VarSpec(column=True), "dt": VarSpec(),
        }
        self.out_vars = {"wk": VarSpec(), "vort": VarSpec()}
        self.stagger = {"vort": (1, 1)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "wk": smooth_field(shape3, 26, 1e-5),
            "vort": np.zeros(shape3), "delpc": s1["delp"],
            "nord_col": _col(self.sizing, 0, self.config.nord),
            "dt": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.a2b_ord4 import a2b_ord4

        if self.config.dddmp < 1e-5:
            vort = torch.zeros_like(t["vort"])
        else:
            vort = a2b_ord4(t["wk"], self.gd, self.dom)
        return {"wk": t["wk"], "vort": vort}


@register("FxAdv")
class TranslateFxAdv(BaseOpCase):
    """reference translate_fxadv.py TranslateFxAdv: uc/vc (+ contra
    storages ut/vt) + dt -> contravariant winds, courant numbers and
    area fluxes (FiniteVolumeFluxPrep)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "uc": VarSpec(), "vc": VarSpec(),
            "uc_contra": VarSpec(serialname="ut"),
            "vc_contra": VarSpec(serialname="vt"),
            "x_area_flux": VarSpec(serialname="xfx_adv", istart=h),
            "crx": VarSpec(serialname="crx_adv", istart=h),
            "y_area_flux": VarSpec(serialname="yfx_adv", jstart=h),
            "cry": VarSpec(serialname="cry_adv", jstart=h),
            "dt": VarSpec(),
        }
        self.out_vars = {
            "uc_contra": VarSpec(serialname="ut"),
            "vc_contra": VarSpec(serialname="vt"),
            "x_area_flux": VarSpec(serialname="xfx_adv", istart=h),
            "crx": VarSpec(serialname="crx_adv", istart=h),
            "y_area_flux": VarSpec(serialname="yfx_adv", jstart=h),
            "cry": VarSpec(serialname="cry_adv", jstart=h),
        }
        self.stagger = {
            "uc": (1, 0), "vc": (0, 1),
            "uc_contra": (1, 0), "vc_contra": (0, 1),
            "x_area_flux": (1, 0), "crx": (1, 0),
            "y_area_flux": (0, 1), "cry": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        zeros = np.zeros(s1["pt"].shape)
        return {
            "uc": s1["uc"], "vc": s1["vc"],
            "uc_contra": zeros, "vc_contra": zeros,
            "x_area_flux": zeros, "crx": zeros,
            "y_area_flux": zeros, "cry": zeros, "dt": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.fxadv import fx_adv

        crx, cry, xaf, yaf, ut, vt = fx_adv(
            t["uc"], t["vc"], t["uc_contra"], t["vc_contra"], self.gd,
            self.dom, float(t["dt"]),
        )
        return {"uc_contra": ut, "vc_contra": vt, "x_area_flux": xaf,
                "crx": crx, "y_area_flux": yaf, "cry": cry}


@register("D2A2C_Vect")
class TranslateD2A2CVect(BaseOpCase):
    """reference translate_d2a2c_vect.py TranslateD2A2C_Vect: D-grid
    winds -> A- and C-grid winds + contravariant components (dord4).
    max_error 2e-10 matches the reference."""

    max_error = 2e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec() for name in
            ("uc", "vc", "u", "v", "ua", "va", "utc", "vtc")
        }
        self.out_vars = {
            name: VarSpec() for name in
            ("uc", "vc", "ua", "va", "utc", "vtc")
        }
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
        }

    def make_inputs(self, s0, s1, gd):
        zeros = np.zeros(s1["pt"].shape)
        return {
            "uc": zeros, "vc": zeros, "u": s1["u"], "v": s1["v"],
            "ua": zeros, "va": zeros, "utc": zeros, "vtc": zeros,
        }

    def run(self, t):
        from pace_torch.ops.d2a2c import d2a2c_vect

        uc, vc, ua, va, ut, vt = d2a2c_vect(t["u"], t["v"], self.gd, self.dom)
        return {"uc": uc, "vc": vc, "ua": ua, "va": va, "utc": ut,
                "vtc": vt}


@register("CubedToLatLon")
class TranslateCubedToLatLon(BaseOpCase):
    """reference translate_cubedtolatlon.py TranslateCubedToLatLon:
    D-grid u/v -> lat/lon A-grid ua/va (ord4 with vector halo)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u": VarSpec(), "v": VarSpec(), "ua": VarSpec(),
            "va": VarSpec(),
        }
        self.out_vars = {
            "ua": VarSpec(), "va": VarSpec(), "u": VarSpec(),
            "v": VarSpec(),
        }
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        zeros = np.zeros(s1["pt"].shape)
        return {"u": s1["u"], "v": s1["v"], "ua": zeros, "va": zeros}

    def run(self, t):
        from pace_torch.ops.c2l_ord import cubed_to_latlon

        ua, va, u, v = cubed_to_latlon(
            t["u"], t["v"], self.gd, get_topology(self.n, self.h), order=4,
        )
        return {"ua": ua, "va": va, "u": u, "v": v}


@register("UpdateDzC")
class TranslateUpdateDzC(BaseOpCase):
    """reference translate_updatedzc.py TranslateUpdateDzC: zs/utc/vtc/
    gz/ws + dt2 -> gz, ws (UpdateGeopotentialHeightOnCGrid)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "zs": VarSpec(),
            "ut": VarSpec(serialname="utc"),
            "vt": VarSpec(serialname="vtc"),
            "gz": VarSpec(), "ws": VarSpec(), "dt2": VarSpec(),
        }
        self.out_vars = {"gz": VarSpec(), "ws": VarSpec()}
        self.stagger = {"ut": (1, 0), "vt": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "zs": s1["phis"] / 9.80665,
            "ut": smooth_field(shape3, 27, 10.0),
            "vt": smooth_field(shape3, 28, 10.0),
            "gz": gz_from_delz(s1["phis"], s1["delz"]),
            "ws": np.zeros(s1["ps"].shape), "dt2": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.updatedz import update_dz_c

        gz, ws = update_dz_c(
            self.tensor(_dp_ref(self.gd)[0]), t["zs"],
            self.gd.horizontal.area, t["ut"], t["vt"], t["gz"], self.dom,
            float(t["dt2"]),
        )
        return {"gz": gz, "ws": ws}


@register("PE_Halo")
class TranslatePEHalo(BaseOpCase):
    """reference translate_pe_halo.py TranslatePE_Halo: pe (i,k,j) +
    delp + ptop -> edge pe on the compute-domain halo ring."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
            "delp": VarSpec(), "ptop": VarSpec(),
        }
        self.out_vars = {
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
        }

    def make_inputs(self, s0, s1, gd):
        return {"pe": s1["pe"], "delp": s1["delp"], "ptop": _ptop(gd)}

    def run(self, t):
        from pace_torch.ops.nh_p_grad import pe_halo

        return {"pe": pe_halo(t["pe"], t["delp"], float(t["ptop"]), self.dom)}


@register("PK3_Halo")
class TranslatePK3Halo(BaseOpCase):
    """reference translate_pk3_halo.py TranslatePK3_Halo: pk3/delp +
    akap/ptop -> pk3 on the halo ring."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "pk3": VarSpec(), "delp": VarSpec(),
            "akap": VarSpec(), "ptop": VarSpec(),
        }
        self.out_vars = {"pk3": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        pk3 = np.concatenate(
            [s1["pk"], s1["pk"][..., -1:]], -1
        ) if s1["pk"].shape[-1] == self.sizing.nz else s1["pk"]
        return {"pk3": pk3, "delp": s1["delp"], "akap": 2.0 / 7.0,
                "ptop": _ptop(gd)}

    def run(self, t):
        from pace_torch.ops.nh_p_grad import pk3_halo

        return {"pk3": pk3_halo(t["pk3"], t["delp"], float(t["ptop"]),
                                float(t["akap"]), self.dom)}


@register("Ray_Fast")
class TranslateRayFast(BaseOpCase):
    """reference translate_ray_fast.py TranslateRay_Fast: u/v/w + dp/
    pfull reference columns + dt/ptop -> Rayleigh-damped winds (the
    nonhydrostatic form: the port runs the nonhydrostatic dycore only)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u": VarSpec(), "v": VarSpec(), "w": VarSpec(),
            "dp": VarSpec(column=True), "pfull": VarSpec(column=True),
            "dt": VarSpec(), "ptop": VarSpec(),
        }
        self.out_vars = {
            "u": VarSpec(), "v": VarSpec(), "w": VarSpec(),
        }
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        dp, ph = _dp_ref(gd)
        return {
            "u": s1["u"], "v": s1["v"], "w": s1["w"],
            "dp": dp, "pfull": dp / np.log(ph[1:] / ph[:-1]),
            "dt": 112.5, "ptop": _ptop(gd),
        }

    def run(self, t):
        from pace_torch.ops.nh_p_grad import ray_fast

        if self.config.hydrostatic:
            raise NotImplementedError("the port's ray_fast is "
                                      "nonhydrostatic only")
        u, v, w = ray_fast(
            t["u"], t["v"], t["w"], np.asarray(t["dp"]),
            np.asarray(t["pfull"]), float(t["dt"]), float(t["ptop"]),
            self.config.rf_cutoff, self.config.tau,
        )
        return {"u": u, "v": v, "w": w}


@register("Neg_Adj3")
class TranslateNegAdj3(BaseOpCase, _TracersMixin):
    """reference translate_neg_adj3.py TranslateNeg_Adj3: tracers +
    pt/delp/delz/peln -> fixed tracers (near-zero errors ignored for
    tracers, as the reference does)."""

    ignore_near_zero_errors = _TracersMixin.TRACERS

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.TRACERS}
        for name in ("pt", "delp", "delz"):
            self.in_vars[name] = VarSpec()
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.out_vars = {name: VarSpec() for name in self.TRACERS}

    def make_inputs(self, s0, s1, gd):
        d = {name: np.array(s1[name]) for name in self.TRACERS}
        # negatives, so that the fixer has work to do
        d["qliquid"][:, self.h + 2, self.h + 3, 5] = -1e-8
        d["qvapor"][:, self.h + 4, self.h + 1, 7] = -1e-9
        d.update(pt=s1["pt"], delp=s1["delp"], delz=s1["delz"],
                 peln=s1["peln"])
        return d

    def run(self, t):
        from pace_torch.ops.neg_adj3 import adjust_negative_tracers

        out, _pt = adjust_negative_tracers(
            {name: t[name] for name in self.TRACERS}, t["pt"], t["delp"])
        return {name: out[name] for name in self.TRACERS}


@register("PressureAdjustedTemperature_NonHydrostatic")
class TranslatePressureAdjustedTemperature(BaseOpCase):
    """reference translate_pressureadjustedtemperature_nonhydrostatic
    .py: cappa/delp/delz/pt + heat_source_dyn + bdt -> diffusively
    heated pt (delt_time_factor = |bdt * delt_max|)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "cappa": VarSpec(), "delp": VarSpec(), "delz": VarSpec(),
            "pt": VarSpec(),
            "heat_source": VarSpec(serialname="heat_source_dyn"),
            "bdt": VarSpec(),
        }
        self.out_vars = {"pt": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        return {
            "cappa": np.full(s1["pt"].shape, 0.28), "delp": s1["delp"],
            "delz": s1["delz"], "pt": s1["pt"],
            "heat_source": smooth_field(s1["pt"].shape, 29, 1e2),
            "bdt": 225.0,
        }

    def run(self, t):
        from pace_torch.ops.nh_p_grad import apply_diffusive_heating

        return {"pt": apply_diffusive_heating(
            t["delp"], t["delz"], t["cappa"], t["heat_source"], t["pt"],
            abs(float(t["bdt"]) * self.config.delt_max))}


@register("LastStep")
class TranslateLastStep(BaseOpCase, _TracersMixin):
    """reference translate_last_step.py TranslateLastStep: tracers/pt/
    pkz + gz1d scratch + r_vir/dtmp -> moist_pt_last_step pt (the gz1d
    output is the bottom-row cvm scratch)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            name: VarSpec() for name in self.TRACERS[:6]
        }
        self.in_vars["pt"] = VarSpec()
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.in_vars["gz"] = VarSpec(serialname="gz1d", no_j=True)
        self.in_vars["r_vir"] = VarSpec()
        self.in_vars["dtmp"] = VarSpec()
        self.out_vars = {
            "gz": VarSpec(serialname="gz1d", no_j=True),
            "pt": VarSpec(),
        }

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.TRACERS[:6]}
        d.update(pt=s1["pt"], pkz=s1["pkz"],
                 gz=np.zeros(s1["pt"].shape[:2]),
                 r_vir=0.608, dtmp=0.02)
        return d

    def run(self, t):
        from pace_torch.ops.moist_cv import moist_pt_last_step

        gz3, pt = moist_pt_last_step(
            *(t[name] for name in ("qvapor", "qliquid", "qrain", "qsnow",
                                   "qice", "qgraupel")),
            t["pt"], t["pkz"], float(t["dtmp"]), float(t["r_vir"]),
        )
        # the reference validates gz1d only as the (i,) row at j=je,
        # k=npz-1 (the stencil's last write)
        return {"gz": gz3[:, :, self.h + self.n - 1, -1], "pt": pt}


class _MoistCV2dBase(BaseOpCase, _TracersMixin):
    """Shared layout of the two j-slab moist_cv savepoints: tracers
    serialized as (i, k) j-slices ('_js' names), gz1d/cvm as i-rows."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec(serialname=name + "_js", no_j=True)
            for name in self.TRACERS[:6]
        }
        for name in ("delp", "delz", "q_con", "pt", "cappa"):
            self.in_vars[name] = VarSpec(no_j=True)

    def make_inputs(self, s0, s1, gd):
        j = self.h  # the serialized j-slice (reference grid.js)
        d = {name: s1[name][:, :, j, :] for name in self.TRACERS[:6]}
        for name in ("delp", "delz", "q_con", "pt"):
            d[name] = s1[name][:, :, j, :]
        d["cappa"] = np.full(s1["pt"][:, :, j, :].shape, 0.28)
        d["r_vir"] = 0.608
        return d

    @staticmethod
    def _tracer_args(t):
        return tuple(t[name] for name in ("qvapor", "qliquid", "qrain",
                                          "qsnow", "qice", "qgraupel"))


@register("MoistCVPlusPt_2d")
class TranslateMoistCVPlusPt2d(_MoistCV2dBase):
    """reference translate_moistcvpluspt_2d.py: j-slab moist_pt ->
    pt/cappa/q_con."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars["r_vir"] = VarSpec()
        self.out_vars = {
            "pt": VarSpec(no_j=True), "cappa": VarSpec(no_j=True),
            "q_con": VarSpec(no_j=True),
        }

    def run(self, t):
        from pace_torch.ops.moist_cv import moist_pt

        _cvm, _gz, q_con, cappa, pt = moist_pt(
            *self._tracer_args(t), t["pt"], t["delp"], t["delz"],
            float(t["r_vir"]),
        )
        return {"pt": pt, "cappa": cappa, "q_con": q_con}


@register("MoistCVPlusPkz_2d")
class TranslateMoistCVPlusPkz2d(_MoistCV2dBase):
    """reference translate_moistcvpluspkz_2d.py: j-slab moist_pkz ->
    pkz/cappa/q_con (+ gz1d/cvm scratch rows)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars["gz"] = VarSpec(serialname="gz1d", no_j=True)
        self.in_vars["cvm"] = VarSpec(no_j=True)
        self.in_vars["pkz"] = VarSpec(no_j=True)
        self.in_vars["r_vir"] = VarSpec()
        self.out_vars = {
            "gz": VarSpec(serialname="gz1d", no_j=True),
            "cvm": VarSpec(no_j=True),
            "pkz": VarSpec(no_j=True), "cappa": VarSpec(no_j=True),
            "q_con": VarSpec(no_j=True),
        }

    def make_inputs(self, s0, s1, gd):
        d = super().make_inputs(s0, s1, gd)
        d["gz"] = np.zeros(s1["pt"].shape[:2])
        d["cvm"] = np.zeros(s1["pt"].shape[:2])
        d["pkz"] = s1["pkz"][:, :, self.h, :]
        return d

    def run(self, t):
        from pace_torch.ops.moist_cv import moist_pkz

        q_con, gz, cvm, cappa, pkz = moist_pkz(
            *self._tracer_args(t), t["pt"], t["delp"], t["delz"],
            float(t["r_vir"]),
        )
        return {"gz": gz[:, :, -1], "cvm": cvm[:, :, -1], "pkz": pkz,
                "cappa": cappa, "q_con": q_con}


@register("XTP_U")
class TranslateXTPU(BaseOpCase):
    """reference translate_xtp_u.py TranslateXTP_U: u + ub (corner
    wind x dt) -> vb flux of u along x."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "u": VarSpec(),
            "c": VarSpec(serialname="ub", istart=h, jstart=h),
            "flux": VarSpec(serialname="vb", istart=h, jstart=h),
        }
        self.out_vars = {
            "flux": VarSpec(serialname="vb", istart=h, jstart=h),
        }
        self.stagger = {
            "u": (0, 1), "c": (1, 1), "flux": (1, 1),
        }

    def make_inputs(self, s0, s1, gd):
        return {
            "u": s1["u"], "c": smooth_field(s1["pt"].shape, 30, 5.0),
            "flux": np.zeros(s1["pt"].shape),
        }

    def run(self, t):
        from pace_torch.ops.xtp import advect_u_along_x

        hz = self.gd.horizontal
        return {"flux": advect_u_along_x(
            t["u"], t["c"], hz.rdx[..., None], hz.dx[..., None],
            hz.dxa[..., None], 1.0, self.dom, self.config.hord_mt)}


@register("YTP_V")
class TranslateYTPV(BaseOpCase):
    """reference translate_ytp_v.py TranslateYTP_V: v + vb (corner
    wind x dt) -> ub flux of v along y."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "c": VarSpec(serialname="vb", istart=h, jstart=h),
            "v": VarSpec(),
            "flux": VarSpec(serialname="ub", istart=h, jstart=h),
        }
        self.out_vars = {
            "flux": VarSpec(serialname="ub", istart=h, jstart=h),
        }
        self.stagger = {
            "v": (1, 0), "c": (1, 1), "flux": (1, 1),
        }

    def make_inputs(self, s0, s1, gd):
        return {
            "v": s1["v"], "c": smooth_field(s1["pt"].shape, 31, 5.0),
            "flux": np.zeros(s1["pt"].shape),
        }

    def run(self, t):
        from pace_torch.ops.xtp import advect_v_along_y

        hz = self.gd.horizontal
        return {"flux": advect_v_along_y(
            t["v"], t["c"], hz.rdy[..., None], hz.dy[..., None],
            hz.dya[..., None], 1.0, self.dom, self.config.hord_mt)}


@register("YPPM")
class TranslateYPPM(BaseOpCase):
    """reference translate_yppm.py TranslateYPPM: q (serial 'q'),
    c (compute-j), param jord (+ ifirst/ilast window markers kept for
    savepoint compatibility) -> flux."""

    q_serial = "q"
    flux_serial = "flux"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "q": VarSpec(serialname=self.q_serial),
            "c": VarSpec(jstart=h),
            "jord": VarSpec(), "ifirst": VarSpec(), "ilast": VarSpec(),
        }
        self.out_vars = {
            "flux": VarSpec(serialname=self.flux_serial, jstart=h),
        }
        self.stagger = {"c": (0, 1), "flux": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        return {
            "q": s1["pt"], "c": smooth_field(s1["pt"].shape, 32, 0.2),
            "jord": 8, "ifirst": self.h, "ilast": self.h + self.n - 1,
        }

    def run(self, t):
        from pace_torch.ops.xppm import y_flux

        return {"flux": y_flux(t["q"], t["c"],
                               self.gd.horizontal.dya[..., None],
                               self.dom, int(t["jord"]))}


@register("YPPM_2")
class TranslateYPPM2(TranslateYPPM):
    """reference translate_yppm.py TranslateYPPM_2: second savepoint
    instance with q_2/flux_2 serial names."""

    q_serial = "q_2"
    flux_serial = "flux_2"


_DIRECTION = {1: "x", 2: "y"}


@register("CopyCorners")
class TranslateCopyCorners(BaseOpCase):
    """reference translate_corners.py TranslateCopyCorners: q + dir
    (1=x, 2=y) -> corner-copied q."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"q": VarSpec(), "dir": VarSpec()}
        self.out_vars = {"q": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        return {"q": s1["pt"], "dir": 1}

    def run(self, t):
        from pace_torch.ops.corners import copy_corners

        return {"q": copy_corners(t["q"], self.dom,
                                  _DIRECTION[int(t["dir"])])}


@register("Fill4Corners")
class TranslateFill4Corners(BaseOpCase):
    """reference translate_corners.py TranslateFill4Corners: q4c + dir
    -> 2-cell corner fills."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {"q4c": VarSpec(), "dir": VarSpec()}
        self.out_vars = {"q4c": VarSpec()}

    def make_inputs(self, s0, s1, gd):
        return {"q4c": s1["pt"], "dir": 1}

    def run(self, t):
        from pace_torch.ops.corners import fill_corners_cells

        q = t["q4c"]
        return {"q4c": fill_corners_cells(q, q, self.dom,
                                          _DIRECTION[int(t["dir"])], 2)}


def _nord_mask(t, like):
    """(1, 1, 1, nz) mask of the levels with a non-zero nord_col."""
    mask = torch.as_tensor(np.asarray(t["nord_col"]) != 0,
                           device=like.device)
    return mask[None, None, None, :]


@register("FillCorners")
class TranslateFillCorners(BaseOpCase):
    """reference translate_corners.py TranslateFillCorners: divg_d
    B-grid corner fill on the k-levels where nord_col != 0."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "divg_d": VarSpec(), "nord_col": VarSpec(column=True),
            "dir": VarSpec(),
        }
        self.out_vars = {"divg_d": VarSpec()}
        self.stagger = {"divg_d": (1, 1)}

    def make_inputs(self, s0, s1, gd):
        return {
            "divg_d": smooth_field(s1["pt"].shape, 33, 1e-5),
            "nord_col": _col(self.sizing, 0, self.config.nord),
            "dir": 1,
        }

    def run(self, t):
        from pace_torch.ops.corners import fill_corners_2d

        q = t["divg_d"]
        filled = fill_corners_2d(q, self.dom, "B",
                                 _DIRECTION[int(t["dir"])])
        return {"divg_d": torch.where(_nord_mask(t, q), filled, q)}


@register("FillCornersVector")
class TranslateFillCornersVector(BaseOpCase):
    """reference translate_corners.py TranslateFillCornersVector:
    vc/uc D-grid vector corner fill (mysign=-1) on nord!=0 levels."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "vc": VarSpec(), "uc": VarSpec(),
            "nord_col": VarSpec(column=True),
        }
        self.out_vars = {"vc": VarSpec(), "uc": VarSpec()}
        self.stagger = {"vc": (0, 1), "uc": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        return {
            "vc": s1["vc"], "uc": s1["uc"],
            "nord_col": _col(self.sizing, 0, self.config.nord),
        }

    def run(self, t):
        from pace_torch.ops.corners import fill_corners_dgrid

        vc, uc = t["vc"], t["uc"]
        x, y = fill_corners_dgrid(vc, uc, self.dom, vector=True)
        mask = _nord_mask(t, vc)
        return {"vc": torch.where(mask, x, vc),
                "uc": torch.where(mask, y, uc)}


@register("QSInit")
class TranslateQSInit(BaseOpCase):
    """reference translate_qsinit.py TranslateQSInit: the saturation
    vapor-pressure tables (table/table2/tablew/des2/desw).  The port
    computes qs analytically (ops/saturation_adjustment.py) and builds
    the reference's 2621-entry tables in numpy (`qs_tables`) for this
    savepoint.  max_error 1e-12 matches the reference."""

    max_error = 1e-12
    NAMES = ("table", "table2", "tablew", "des2", "desw")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {n: VarSpec(column=True) for n in self.NAMES}
        self.out_vars = {n: VarSpec(column=True) for n in self.NAMES}

    def make_inputs(self, s0, s1, gd):
        from pace_torch.ops.saturation_adjustment import qs_tables

        return dict(zip(self.NAMES, qs_tables()))

    def run(self, t):
        from pace_torch.ops.saturation_adjustment import qs_tables

        return dict(zip(self.NAMES, qs_tables()))


@register("SatAdjust3d")
class TranslateSatAdjust3d(BaseOpCase, _TracersMixin):
    """reference translate_satadjust3d.py TranslateSatAdjust3d: fast
    saturation adjustment inside the remap last step.  te rides along
    unchanged (consv_te=0, as every exercised config).  max_error
    2e-11 matches the reference."""

    max_error = 2e-11
    ignore_near_zero_errors = _TracersMixin.TRACERS + ("q_con",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.TRACERS}
        for name in ("te", "hs", "delp", "delz", "q_con", "pt",
                     "cappa"):
            self.in_vars[name] = VarSpec()
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        for p in ("r_vir", "mdt", "fast_mp_consv", "last_step", "akap",
                  "kmp"):
            self.in_vars[p] = VarSpec()
        self.out_vars = {name: VarSpec() for name in self.TRACERS}
        for name in ("te", "q_con", "pt", "cappa"):
            self.out_vars[name] = VarSpec()
        self.out_vars["pkz"] = VarSpec(istart=h, jstart=h)

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.TRACERS}
        shape3 = s1["pt"].shape
        d.update(
            te=np.zeros(shape3), hs=s1["phis"], delp=s1["delp"],
            delz=s1["delz"], q_con=s1["q_con"], pt=s1["pt"],
            cappa=np.full(shape3, 0.28), peln=s1["peln"],
            pkz=s1["pkz"], r_vir=0.608, mdt=225.0, fast_mp_consv=0,
            last_step=1, akap=2.0 / 7.0, kmp=1,
        )
        return d

    def run(self, t):
        from pace_torch.ops.saturation_adjustment import (
            saturation_adjustment,
        )

        out_tracers, q_con, pt, pkz, cappa, _dp, _dz, _pe = (
            saturation_adjustment(
                t["delp"], {name: t[name] for name in self.TRACERS},
                t["hs"], t["peln"], t["delp"], t["delz"], t["q_con"],
                t["pt"], t["pkz"], t["cappa"], float(t["r_vir"]),
                float(t["mdt"]), bool(t["last_step"]), float(t["akap"]),
                self.gd, self.config, self.n, self.h,
            )
        )
        result = {name: out_tracers[name] for name in self.TRACERS}
        result.update(te=t["te"], q_con=q_con, pt=pt, pkz=pkz,
                      cappa=cappa)
        return result


@register("FVSubgridZ")
class TranslateFVSubgridZ(BaseOpCase, _TracersMixin):
    """reference translate_fvsubgridz.py TranslateFVSubgridZ: dry
    convective adjustment in the top sponge (state fields + tracers +
    u_dt/v_dt accumulators -> mixed state and wind tendencies)."""

    ALL_TRACERS = ("qvapor", "qliquid", "qrain", "qsnow", "qice",
                   "qgraupel", "qo3mr", "qsgs_tke", "qcld")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.ALL_TRACERS}
        for name in ("delp", "delz", "pt", "ua", "va", "w", "u_dt",
                     "v_dt"):
            self.in_vars[name] = VarSpec()
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.in_vars["dt"] = VarSpec()
        self.out_vars = {
            name: VarSpec() for name in self.ALL_TRACERS
            if name not in ("qo3mr", "qsgs_tke")
        }
        for name in ("pt", "ua", "va", "w", "u_dt", "v_dt"):
            self.out_vars[name] = VarSpec()

    def make_inputs(self, s0, s1, gd):
        zeros = np.zeros(s1["pt"].shape)
        d = {name: s1.get(name, zeros) for name in self.ALL_TRACERS}
        d.update(
            delp=s1["delp"], delz=s1["delz"], pt=s1["pt"],
            ua=s1["ua"], va=s1["va"], w=s1["w"], u_dt=zeros,
            v_dt=zeros, pe=s1["pe"], peln=s1["peln"], pkz=s1["pkz"],
            dt=225.0,
        )
        return d

    def run(self, t):
        from pace_torch.ops.fv_subgridz import dry_convective_adjustment

        s = {name: t[name] for name in self.ALL_TRACERS + (
            "delp", "delz", "pt", "ua", "va", "w", "peln", "pkz")}
        out, u_dt, v_dt = dry_convective_adjustment(
            s, float(t["dt"]), fv_sg_adj=3600.0,
            n_sponge=self.config.n_sponge, nwat=self.config.nwat,
            hydrostatic=False, ptop=_ptop(self.gd),
        )
        result = {name: out[name] for name in self.out_vars if name in out}
        result["u_dt"] = u_dt + t["u_dt"]
        result["v_dt"] = v_dt + t["v_dt"]
        for name in self.out_vars:
            result.setdefault(name, t[name])
        return result


# ---------------------------------------------------------------------------
# the c_sw/d_sw sub-stage classes, the XPPM_2/FvTp2d_2 variants and the
# DynCore acoustic-step savepoint
# ---------------------------------------------------------------------------


@register("DivergenceCorner")
class TranslateDivergenceCorner(BaseOpCase):
    """reference translate_c_sw.py TranslateDivergenceCorner (:116):
    u/v/ua/va -> divg_d on cell corners; max_error 9e-10."""

    max_error = 9e-10

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u": VarSpec(), "v": VarSpec(), "ua": VarSpec(),
            "va": VarSpec(), "divg_d": VarSpec(),
        }
        self.out_vars = {"divg_d": VarSpec()}
        self.stagger = {"u": (0, 1), "v": (1, 0), "divg_d": (1, 1)}

    def make_inputs(self, s0, s1, gd):
        return {
            "u": s1["u"], "v": s1["v"], "ua": s1["ua"], "va": s1["va"],
            "divg_d": np.zeros_like(s1["pt"]),
        }

    def run(self, t):
        from pace_torch.ops.c_sw import divergence_corner

        return {"divg_d": divergence_corner(t["u"], t["v"], t["ua"],
                                            t["va"], self.gd, self.dom)}


@register("Circulation_Cgrid")
class TranslateCirculationCgrid(BaseOpCase):
    """reference translate_c_sw.py TranslateCirculation_Cgrid (:174):
    uc/vc -> raw corner circulation vort_c (is_-1..ie+1 block);
    max_error 5e-9."""

    max_error = 5e-9

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "uc": VarSpec(), "vc": VarSpec(),
            "vort_c": VarSpec(istart=h - 1, jstart=h - 1),
        }
        self.out_vars = {"vort_c": VarSpec(istart=h - 1, jstart=h - 1)}
        # vort_c block spans is_-1 .. ie+1 = nsub + 3 points
        self.stagger = {"uc": (1, 0), "vc": (0, 1), "vort_c": (3, 3)}

    def make_inputs(self, s0, s1, gd):
        return {"uc": s1["uc"], "vc": s1["vc"],
                "vort_c": np.zeros_like(s1["pt"])}

    def run(self, t):
        from pace_torch.ops.c_sw import circulation_cgrid

        return {"vort_c": circulation_cgrid(t["uc"], t["vc"], self.gd,
                                            self.dom)}


@register("VorticityTransport_Cgrid")
class TranslateVorticityTransportCgrid(BaseOpCase):
    """reference translate_c_sw.py TranslateVorticityTransport_Cgrid
    (:216): uc/vc updated from vort_c, ke_c, and the D-grid winds (the
    port's vorticity_transport_cgrid takes vort_c and ke as given, the
    reference's vorticity_transport_cgrid_core)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "uc": VarSpec(), "vc": VarSpec(),
            "vort_c": VarSpec(istart=h - 1, jstart=h - 1),
            "ke_c": VarSpec(istart=h - 1, jstart=h - 1),
            "u": VarSpec(), "v": VarSpec(),
            "dt2": VarSpec(),
        }
        self.out_vars = {
            "uc": VarSpec(istart=h, jstart=h),
            "vc": VarSpec(istart=h, jstart=h),
        }
        self.stagger = {"vort_c": (3, 3), "ke_c": (3, 3),
                        "uc": (1, 0), "vc": (0, 1),
                        "u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        fC = as_numpy(gd.horizontal.fC)[..., None]
        rac = as_numpy(gd.horizontal.rarea_c)[..., None]
        return {
            "uc": s1["uc"], "vc": s1["vc"],
            "vort_c": fC + rac * smooth_field(s1["pt"].shape, 51, 1e5),
            "ke_c": smooth_field(s1["pt"].shape, 52, 1e2),
            "u": s1["u"], "v": s1["v"], "dt2": 112.5,
        }

    def run(self, t):
        from pace_torch.ops.c_sw import vorticity_transport_cgrid

        uc, vc = vorticity_transport_cgrid(
            t["uc"], t["vc"], t["vort_c"], t["ke_c"], t["u"], t["v"],
            self.gd, self.dom, float(t["dt2"]),
        )
        return {"uc": uc, "vc": vc}


class _BKECase(BaseOpCase):
    """Shared shape for UbKE/VbKE (reference translate_d_sw.py:84,131):
    C-grid winds + advective wind -> B-grid (corner) contravariant wind
    times 2*dt5, on the compute+1 corner block."""

    wind_out = "ub"  # "ub" or "vb"

    @property
    def _adv(self):
        return "ut" if self.wind_out == "ub" else "vt"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "uc": VarSpec(), "vc": VarSpec(), self._adv: VarSpec(),
            self.wind_out: VarSpec(istart=h, jstart=h),
            "dt5": VarSpec(), "dt4": VarSpec(),
        }
        self.out_vars = {self.wind_out: VarSpec(istart=h, jstart=h)}
        self.stagger = {"uc": (1, 0), "vc": (0, 1),
                        self.wind_out: (1, 1)}

    def make_inputs(self, s0, s1, gd):
        return {
            "uc": s1["uc"], "vc": s1["vc"],
            self._adv: smooth_field(s1["pt"].shape, 53, 10.0),
            self.wind_out: np.zeros_like(s1["pt"]),
            "dt5": 56.25, "dt4": 28.125,
        }

    def run(self, t):
        from pace_torch.ops.d_sw import _interpolate_uc_vc_to_corners

        adv = t[self._adv]
        # the reference stencil passes the same advective wind for both
        # slots (translate_d_sw.py ubke/vbke call
        # interpolate_uc_vc_to_cell_corners(uc, vc, ..., ut, ut))
        ub_c, vb_c = _interpolate_uc_vc_to_corners(
            t["uc"], t["vc"], adv, adv, self.gd, self.dom)
        out = ub_c if self.wind_out == "ub" else vb_c
        return {self.wind_out: out * (2.0 * float(t["dt5"]))}


@register("UbKE")
class TranslateUbKE(_BKECase):
    wind_out = "ub"


@register("VbKE")
class TranslateVbKE(_BKECase):
    wind_out = "vb"


@register("FluxCapacitor")
class TranslateFluxCapacitor(BaseOpCase):
    """reference translate_d_sw.py TranslateFluxCapacitor (:162):
    accumulate courant numbers and mass fluxes (d_sw.py flux_capacitor
    stencil :33-60)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "cx": VarSpec(istart=h), "cy": VarSpec(jstart=h),
            "xflux": VarSpec(istart=h, jstart=h),
            "yflux": VarSpec(istart=h, jstart=h),
            "crx_adv": VarSpec(istart=h), "cry_adv": VarSpec(jstart=h),
            "fx": VarSpec(istart=h, jstart=h),
            "fy": VarSpec(istart=h, jstart=h),
        }
        self.out_vars = {name: self.in_vars[name]
                         for name in ("cx", "cy", "xflux", "yflux")}
        self.stagger = {"cx": (1, 0), "crx_adv": (1, 0),
                        "xflux": (1, 0), "fx": (1, 0),
                        "cy": (0, 1), "cry_adv": (0, 1),
                        "yflux": (0, 1), "fy": (0, 1)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "cx": s1["cxd"], "cy": s1["cyd"], "xflux": s1["mfxd"],
            "yflux": s1["mfyd"],
            "crx_adv": smooth_field(shape3, 54, 0.2),
            "cry_adv": smooth_field(shape3, 55, 0.2),
            "fx": smooth_field(shape3, 56, 1e9),
            "fy": smooth_field(shape3, 57, 1e9),
        }

    def run(self, t):
        return {"cx": t["cx"] + t["crx_adv"], "cy": t["cy"] + t["cry_adv"],
                "xflux": t["xflux"] + t["fx"],
                "yflux": t["yflux"] + t["fy"]}


@register("HeatDiss")
class TranslateHeatDiss(BaseOpCase):
    """reference translate_d_sw.py TranslateHeatDiss (:191): heating from
    vertical-wind damping (d_sw.py heat_diss :63; the damp_w/ke_bg
    columns come from the column namelist, not the savepoint)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "fx2": VarSpec(), "fy2": VarSpec(), "w": VarSpec(),
            "dw": VarSpec(), "heat_source": VarSpec(),
            "diss_est": VarSpec(),
        }
        self.out_vars = {
            "heat_source": VarSpec(istart=h, jstart=h),
            "diss_est": VarSpec(istart=h, jstart=h),
            "dw": VarSpec(istart=h, jstart=h),
        }

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "fx2": smooth_field(shape3, 58, 1e2),
            "fy2": smooth_field(shape3, 59, 1e2),
            "w": s1["w"], "dw": np.zeros(shape3),
            "heat_source": np.zeros(shape3),
            "diss_est": np.zeros(shape3),
        }

    def run(self, t):
        from pace_torch.ops.stencil_utils import shift

        col = get_column_namelist(self.config, self.sizing.nz)
        dt = 450.0 / self.config.k_split / self.config.n_split
        rarea = self.gd.horizontal.rarea[..., None]
        fx2, fy2, w = t["fx2"], t["fy2"], t["w"]
        damp_mask = torch.as_tensor(col["damp_w"] > 1e-5,
                                    device=w.device).reshape(1, 1, 1, -1)
        dd8 = self.tensor(col["ke_bg"]).reshape(1, 1, 1, -1) * abs(dt)
        dw = torch.where(
            damp_mask,
            (fx2 - shift(fx2, 1) + fy2 - shift(fy2, 0, 1)) * rarea, 0.0)
        heat = torch.where(damp_mask, dd8 - dw * (w + 0.5 * dw), 0.0)
        return {"heat_source": heat,
                "diss_est": torch.where(damp_mask, heat, 0.0), "dw": dw}


@register("Wdivergence")
class TranslateWdivergence(BaseOpCase):
    """reference translate_d_sw.py TranslateWdivergence (:235): apply
    fluxes to w (d_sw.py apply_fluxes :122 -- output is mass-weighted
    q*delp + flux increment; serialized under the name 'w')."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "q": VarSpec(serialname="w"), "delp": VarSpec(),
            "gx": VarSpec(), "gy": VarSpec(),
        }
        h = self.h
        self.out_vars = {"q": VarSpec(serialname="w", istart=h, jstart=h)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "q": s1["w"], "delp": s1["delp"],
            "gx": smooth_field(shape3, 60, 1e9),
            "gy": smooth_field(shape3, 61, 1e9),
        }

    def run(self, t):
        from pace_torch.ops.d_sw import flux_increment

        return {"q": t["q"] * t["delp"] + flux_increment(
            t["gx"], t["gy"], self.gd.horizontal.rarea[..., None])}


@register("XPPM_2")
class TranslateXPPM2(TranslateXPPM):
    """reference translate_xppm.py TranslateXPPM_2 (:61): same op, q
    serialized under its plain name and the flux under 'xflux_2'."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars["q"] = VarSpec(serialname="q")
        self.out_vars["xflux"] = VarSpec(serialname="xflux_2",
                                         istart=self.h, jstart=self.h)

    def make_inputs(self, s0, s1, gd):
        return {"q": s1["pt"], "c": smooth_field(s1["pt"].shape, 62, 0.2),
                "iord": 8}


@register("FvTp2d_2")
class TranslateFvTp2d2(TranslateFvTp2d):
    """reference translate_fvtp2d.py TranslateFvTp2d_2 (:78): the
    mass-flux-less variant (area fluxes only)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        del self.in_vars["x_mass_flux"]
        del self.in_vars["y_mass_flux"]
        for name in ("x_mass_flux", "y_mass_flux"):
            self.stagger.pop(name, None)

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "q": s1["pt"],
            "crx": smooth_field(shape3, 63, 0.2),
            "cry": smooth_field(shape3, 64, 0.2),
            "x_area_flux": smooth_field(shape3, 65, 1e7),
            "y_area_flux": smooth_field(shape3, 66, 1e7),
            "hord": 6,
        }


@register("DynCore")
class TranslateDynCore(BaseOpCase):
    """reference translate_dyncore.py TranslateDynCore: the acoustic
    step (AcousticDynamics.__call__) savepoint.  In/out sets mirror the
    reference's (:60-110: state fields incl. pe/pk/peln blocks, wsd,
    accumulators; out drops ak/bk/phis/pkz); parameters mdt/akap/ptop/
    n_map.  max_error 2e-6 matches the reference setting."""

    max_error = 2e-6
    ignore_near_zero_errors = ("wsd",)

    STATE3 = ("cappa", "u", "v", "w", "delz", "delp", "pt", "omga",
              "ua", "va", "uc", "vc", "q_con", "diss_estd")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {name: VarSpec() for name in self.STATE3}
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1, kaxis=1)
        self.in_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["phis"] = VarSpec()
        self.in_vars["wsd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["mfxd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["mfyd"] = VarSpec(istart=h, jstart=h)
        self.in_vars["cxd"] = VarSpec(istart=h)
        self.in_vars["cyd"] = VarSpec(jstart=h)
        self.in_vars["pkz"] = VarSpec(istart=h, jstart=h)
        self.in_vars["ak"] = VarSpec(column=True)
        self.in_vars["bk"] = VarSpec(column=True)
        for p in ("mdt", "akap", "ptop", "n_map"):
            self.in_vars[p] = VarSpec()
        self.out_vars = {
            name: spec for name, spec in self.in_vars.items()
            if name not in ("ak", "bk", "phis", "pkz", "mdt", "akap",
                            "ptop", "n_map")
        }
        self.stagger = {
            "u": (0, 1), "vc": (0, 1), "v": (1, 0), "uc": (1, 0),
            "mfxd": (1, 0), "cxd": (1, 0), "mfyd": (0, 1), "cyd": (0, 1),
        }

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.STATE3 if name in s1}
        d["cappa"] = np.full(s1["pt"].shape, 0.28)
        d.update(
            pe=s1["pe"], pk=s1["pk"], peln=s1["peln"],
            phis=s1["phis"], wsd=np.zeros(s1["ps"].shape),
            mfxd=s1["mfxd"], mfyd=s1["mfyd"], cxd=s1["cxd"],
            cyd=s1["cyd"], pkz=s1["pkz"],
            ak=as_numpy(gd.vertical.ak), bk=as_numpy(gd.vertical.bk),
            mdt=225.0, akap=2.0 / 7.0, ptop=_ptop(gd), n_map=1,
        )
        return d

    def run(self, t):
        from pace_torch.models.fv3 import acoustics
        from pace_torch.models.fv3.dynamics import DynamicalCore
        from pace_torch.models.fv3.state import FIELD_METADATA

        # timestep here is the k_split-subdivided mdt, what the reference
        # passes (translate_dyncore.py: acoustic_dynamics(state,
        # timestep=inputs["mdt"], n_map=state.n_map))
        core = DynamicalCore(self.config, self.sizing, self.gd,
                             timestep=float(t["mdt"]) * self.config.k_split)
        state = _dycore_state(t)
        s = {f: getattr(state, f) for f in FIELD_METADATA}
        s, cappa, wsd, _pem = acoustics.acoustic_dynamics(
            s, t["cappa"], self.gd, core.column_namelist, self.config,
            core.topo, float(t["mdt"]), int(t["n_map"]),
            t["wsd"], core.vertical_params,
        )
        out = {name: s[name] for name in self.out_vars if name in s}
        out["cappa"] = cappa
        out["wsd"] = wsd
        return out
