"""Physics translate cases: reference physics savepoint classes ->
pace_torch physics and coupler ops.

The port's counterpart of `pace_tpu.utils.translate_cases_physics`:
every class under the reference's physics/tests/savepoint/translate/ (10
classes) plus the coupler's UpdateDWindsPhys and the coupled Driver step,
with the same serialized variable names and the GFS "IPD" block layouts
((cn*cn, nz) Fortran blocks with k stored surface-up: VarSpec
phys_order/microph in utils/translate.py, the analogue of
translate_physics.py transform_*_serialized_data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.parallel.topology import get_topology
from pace_torch.utils.translate import VarSpec
from pace_torch.utils.translate_cases import (
    BaseOpCase,
    TranslateFVDynamics,
    _dycore_state,
    _ptop,
    _TracersMixin,
    gz_from_delz,
    register,
    smooth_field,
)

GFS_TRACERS = ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel",
               "qo3mr", "qsgs_tke", "qcld")


class BasePhysCase(BaseOpCase):
    """BaseOpCase plus the physics namelist bundle."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.phys_config = PhysicsConfig(npz=self.sizing.nz)

    def _physics_state(self, t):
        """PhysicsState with the given fields; the rest zeros."""
        from pace_torch.models.physics.physics_state import PhysicsState

        shape3 = next(iter(t.values())).shape
        state = PhysicsState.init_zeros(shape3, device=self.device,
                                        dtype=self.torch_dtype)
        known = {f.name for f in dataclasses.fields(PhysicsState)}
        return dataclasses.replace(
            state, **{k: v for k, v in t.items() if k in known})


def _interfaces_from_delp(s1, gd):
    """Interface pressures ptop + cumsum(delp), (..., nz + 1)."""
    ptop = _ptop(gd)
    return np.concatenate(
        [np.full(s1["pt"].shape[:3] + (1,), ptop),
         ptop + np.cumsum(s1["delp"], -1)], -1)


_GQ0 = ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel", "qcld")


@register("AtmosPhysDriverStatein")
class TranslateAtmosPhysDriverStatein(BasePhysCase):
    """reference translate_atmos_phy_statein.py: dycore fields ->
    GFS statein blocks (IPD_prsik/prsi/phii/tgrs/qgrs/prsl)."""

    DYCORE = ("delz", "delp", "qvapor", "qliquid", "qrain", "qice",
              "qsnow", "qgraupel", "qo3mr", "qcld", "pt")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "prsik": VarSpec(serialname="IPD_prsik", phys_order="F"),
            "phii": VarSpec(serialname="IPD_phii", phys_order="F"),
            "prsi": VarSpec(serialname="IPD_prsi", phys_order="F"),
        }
        for name in self.DYCORE:
            self.in_vars[name] = VarSpec()
        self.out_vars = {
            "prsik": VarSpec(serialname="IPD_prsik", phys_order="F"),
            "prsi": VarSpec(serialname="IPD_prsi", phys_order="F"),
            "phii": VarSpec(serialname="IPD_phii", phys_order="F"),
            "tgrs": VarSpec(serialname="IPD_tgrs", phys_order="F",
                            roll_zero=True),
            "qgrs": VarSpec(serialname="IPD_qgrs", phys_order="F"),
            "prsl": VarSpec(serialname="IPD_prsl", phys_order="F",
                            roll_zero=True),
        }

    def make_inputs(self, s0, s1, gd):
        zi = np.zeros(s1["pt"].shape[:3] + (self.sizing.nz + 1,))
        d = {name: s1[name] for name in self.DYCORE if name in s1}
        d["qo3mr"] = np.zeros(s1["pt"].shape)
        d.update(prsik=zi, phii=zi, prsi=zi)
        return d

    def run(self, t):
        from pace_torch.models.physics.physics import (
            atmos_phys_driver_statein,
        )
        from pace_torch.utils import constants as con

        ptop = _ptop(self.gd)
        state = self._physics_state(
            {k: t[k] for k in self.DYCORE if k in t})
        state = dataclasses.replace(state,
                                    qsgs_tke=torch.zeros_like(state.pt))
        out = atmos_phys_driver_statein(
            state, ptop, (ptop / 1.0e5) ** con.KAPPA,
            (1.0 / 1.0e5) ** con.KAPPA, nwat=6,
        )
        return {
            "prsik": out.prsik, "prsi": out.prsi, "phii": out.phii,
            "tgrs": t["pt"],
            "qgrs": torch.stack([getattr(out, name)
                                 for name in GFS_TRACERS], -1),
            "prsl": out.delp,
        }


@register("FillGFS")
class TranslateFillGFS(BasePhysCase):
    """reference translate_fillgfs.py: IPD_prsi + IPD_gq0 -> vapor
    column fill (fill_gfs_delp) -> IPD_qvapor."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "pe": VarSpec(serialname="IPD_prsi", phys_order="C"),
            "q": VarSpec(serialname="IPD_gq0", phys_order="C"),
        }
        self.out_vars = {
            "q": VarSpec(serialname="IPD_qvapor", phys_order="C"),
        }

    def make_inputs(self, s0, s1, gd):
        q = np.stack([s1[name] for name in _GQ0], -1)
        q[:, self.h + 1, self.h + 2, 3, 0] = -1e-9
        return {"pe": _interfaces_from_delp(s1, gd), "q": q}

    def run(self, t):
        from pace_torch.models.coupler.update_atmos_state import (
            fill_gfs_delp,
        )

        pe, q = t["pe"], t["q"]
        out = q.clone()
        out[..., 0] = fill_gfs_delp(pe[..., 1:] - pe[..., :-1], q[..., 0],
                                    q_min=1.0e-9)
        return {"q": out}


@register("PrsFV3")
class TranslatePrsFV3(BasePhysCase):
    """reference translate_prsfv3.py: phii/prsi/tgrs/qgrs -> layer
    thickness del_ and dry del_gz (get_prs_fv3)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "phii": VarSpec(serialname="prs_phii", phys_order="C"),
            "prsi": VarSpec(serialname="prs_prsi", phys_order="C"),
            "tgrs": VarSpec(serialname="prs_tgrs", phys_order="C"),
            "qgrs": VarSpec(serialname="prs_qgrs", phys_order="C"),
            "del_": VarSpec(serialname="prs_del", phys_order="C"),
            "del_gz": VarSpec(serialname="prs_del_gz", phys_order="C",
                              roll_zero=True),
        }
        self.out_vars = {
            "del_": VarSpec(serialname="prs_del", phys_order="C"),
            "del_gz": VarSpec(serialname="prs_del_gz", phys_order="C",
                              roll_zero=True),
        }

    def make_inputs(self, s0, s1, gd):
        return {
            "phii": gz_from_delz(s1["phis"], s1["delz"]) * 9.80665,
            "prsi": _interfaces_from_delp(s1, gd), "tgrs": s1["pt"],
            "qgrs": np.stack([s1[name] for name in _GQ0], -1),
            "del_": np.zeros(s1["pt"].shape),
            "del_gz": np.zeros(s1["pt"].shape[:3] + (self.sizing.nz + 1,)),
        }

    def run(self, t):
        from pace_torch.models.physics.physics import get_prs_fv3

        del_, del_gz = get_prs_fv3(t["phii"], t["prsi"], t["tgrs"],
                                   t["qgrs"][..., 0])
        out_gz = t["del_gz"].clone()
        out_gz[..., :del_gz.shape[-1]] = del_gz
        return {"del_": del_, "del_gz": out_gz}


@register("PhiFV3")
class TranslatePhiFV3(BasePhysCase):
    """reference translate_phifv3.py: gt0/gq0/del_gz -> geopotentials
    phii/phil (get_phi_fv3)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "gt0": VarSpec(serialname="phi_gt0", phys_order="C"),
            "gq0": VarSpec(serialname="phi_gq0", phys_order="C"),
            "del_gz": VarSpec(serialname="phi_del_gz", phys_order="C",
                              roll_zero=True),
            "phii": VarSpec(serialname="phi_phii", phys_order="C"),
            "phil": VarSpec(serialname="phi_phil", phys_order="C"),
        }
        self.out_vars = {
            "del_gz": VarSpec(serialname="phi_del_gz", phys_order="C",
                              roll_zero=True),
            "phii": VarSpec(serialname="phi_phii", phys_order="C"),
            "phil": VarSpec(serialname="phi_phil", phys_order="C"),
        }

    def make_inputs(self, s0, s1, gd):
        import pace_torch.utils.constants as con

        nzi = self.sizing.nz + 1
        del_gz = np.zeros(s1["pt"].shape[:3] + (nzi,))
        del_gz[..., :-1] = (
            -s1["delz"] * con.GRAV / s1["pt"]
            / (1.0 + con.ZVIR * s1["qvapor"])
        )
        return {
            "gt0": s1["pt"], "gq0": np.stack([s1[name] for name in _GQ0],
                                             -1),
            "del_gz": del_gz,
            "phii": np.zeros(s1["pt"].shape[:3] + (nzi,)),
            "phil": np.zeros(s1["pt"].shape),
        }

    def run(self, t):
        from pace_torch.models.physics.physics import get_phi_fv3

        phii, phil = get_phi_fv3(t["gt0"], t["gq0"][..., 0],
                                 t["del_gz"][..., :-1])
        return {"del_gz": t["del_gz"], "phii": phii, "phil": phil}


@register("PhysUpdatePressureSurfaceWinds")
class TranslatePhysUpdatePressureSurfaceWinds(BasePhysCase):
    """reference translate_update_pressure_sfc_winds_phys.py: dycore
    pressure fields + A-grid winds -> pe/peln/pk/ps/u_srf/v_srf."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "peln": VarSpec(istart=h, jstart=h, kaxis=1),
            "pk": VarSpec(istart=h, jstart=h),
            "delp": VarSpec(),
            "pe": VarSpec(istart=h - 1, jstart=h - 1, kaxis=1),
            "ps": VarSpec(), "ua": VarSpec(), "va": VarSpec(),
            "u_srf": VarSpec(), "v_srf": VarSpec(),
        }
        self.out_vars = {
            "pk": VarSpec(istart=h, jstart=h),
            "ps": VarSpec(), "u_srf": VarSpec(), "v_srf": VarSpec(),
        }

    def make_inputs(self, s0, s1, gd):
        shape2 = s1["ps"].shape
        return {
            "peln": s1["peln"], "pk": s1["pk"], "delp": s1["delp"],
            "pe": s1["pe"], "ps": s1["ps"], "ua": s1["ua"],
            "va": s1["va"], "u_srf": np.zeros(shape2),
            "v_srf": np.zeros(shape2),
        }

    def run(self, t):
        from pace_torch.models.coupler.fv_update_phys import (
            update_pressure_and_surface_winds,
        )

        _pe, _peln, pk, ps, u_srf, v_srf = update_pressure_and_surface_winds(
            t["pe"], t["delp"], t["peln"], t["pk"], t["ua"], t["va"])
        return {"pk": pk, "ps": ps, "u_srf": u_srf, "v_srf": v_srf}


@register("PhysUpdateTracers")
class TranslatePhysUpdateTracers(BasePhysCase):
    """reference translate_update_tracers_phys.py: physics-updated
    fields (t1) vs pre-physics (t0) -> wind/temperature tendencies and
    FV3 tracer/delp writeback."""

    T1 = {
        "physics_updated_pt": "pt_t1",
        "physics_updated_specific_humidity": "qvapor_t1",
        "physics_updated_qliquid": "qliquid_t1",
        "physics_updated_qrain": "qrain_t1",
        "physics_updated_qsnow": "qsnow_t1",
        "physics_updated_qice": "qice_t1",
        "physics_updated_qgraupel": "qgraupel_t1",
    }
    T0_TRACERS = ("qvapor_t0", "qliquid_t0", "qrain_t0", "qsnow_t0",
                  "qice_t0", "qgraupel_t0")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u_dt": VarSpec(), "v_dt": VarSpec(),
            "pt_dt": VarSpec(serialname="t_dt"),
            "u_t1": VarSpec(phys_order="F"),
            "v_t1": VarSpec(phys_order="F"),
        }
        for name, serial in self.T1.items():
            self.in_vars[name] = VarSpec(serialname=serial,
                                         phys_order="F")
        for name in ("u_t0", "v_t0", "pt_t0"):
            self.in_vars[name] = VarSpec(phys_order="F")
        for name in self.T0_TRACERS:
            self.in_vars[name] = VarSpec()
        self.in_vars["prsi"] = VarSpec(serialname="IPD_prsi",
                                       phys_order="F")
        self.in_vars["delp"] = VarSpec(serialname="IPD_delp")
        self.in_vars["rdt"] = VarSpec()
        self.out_vars = {
            "u_dt": VarSpec(), "v_dt": VarSpec(),
            "pt_dt": VarSpec(serialname="t_dt"),
            "delp": VarSpec(serialname="IPD_delp"),
        }
        for name in self.T0_TRACERS:
            self.out_vars[name] = VarSpec()

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        d = {
            "u_dt": np.zeros(shape3), "v_dt": np.zeros(shape3),
            "pt_dt": np.zeros(shape3),
            "u_t1": s1["ua"] + 0.01, "v_t1": s1["va"] + 0.01,
            "u_t0": s1["ua"], "v_t0": s1["va"], "pt_t0": s1["pt"],
            "prsi": _interfaces_from_delp(s1, gd), "delp": s1["delp"],
            "rdt": 1.0 / 225.0,
        }
        d["physics_updated_pt"] = s1["pt"] + 0.05
        d["physics_updated_specific_humidity"] = s1["qvapor"] * 1.001
        for name, serial in self.T1.items():
            if name not in d:
                d[name] = s1[serial.replace("_t1", "")] * 1.001
        for name in self.T0_TRACERS:
            d[name] = s1[name.replace("_t0", "")]
        return d

    def run(self, t):
        from pace_torch.models.coupler.update_atmos_state import (
            prepare_tendencies_and_update_tracers,
        )

        state = self._physics_state({name: t[name] for name in self.T1})
        state = dataclasses.replace(
            state, ua=t["u_t0"], va=t["v_t0"], pt=t["pt_t0"],
            physics_updated_ua=t["u_t1"], physics_updated_va=t["v_t1"],
            prsi=t["prsi"])
        dyc = {name.replace("_t0", ""): t[name] for name in self.T0_TRACERS}
        dyc["delp"] = t["delp"]
        u_dt, v_dt, pt_dt, new_tracers, new_delp = (
            prepare_tendencies_and_update_tracers(
                t["u_dt"], t["v_dt"], t["pt_dt"], state, dyc,
                float(t["rdt"])))
        result = {"u_dt": u_dt, "v_dt": v_dt, "pt_dt": pt_dt,
                  "delp": new_delp}
        for name in self.T0_TRACERS:
            result[name] = new_tracers[name.replace("_t0", "")]
        return result


@register("Microph")
class TranslateMicroph(BasePhysCase):
    """reference translate_microphysics.py TranslateMicroph: GFDL
    cloud microphysics one call -> tendencies (mph_* blocks)."""

    IN3 = {
        "qvapor": "mph_qv1", "qliquid": "mph_ql1", "qrain": "mph_qr1",
        "qice": "mph_qi1", "qsnow": "mph_qs1", "qgraupel": "mph_qg1",
        "qcld": "mph_qa1", "ua": "mph_uin", "va": "mph_vin",
        "delprsi": "mph_delp", "wmp": "mph_w", "delz": "mph_dz",
        "pt": "mph_pt",
    }
    OUT = {
        "pt_dt": "mph_pt_dt", "qv_dt": "mph_qv_dt", "ql_dt": "mph_ql_dt",
        "qr_dt": "mph_qr_dt", "qi_dt": "mph_qi_dt", "qs_dt": "mph_qs_dt",
        "qg_dt": "mph_qg_dt", "qa_dt": "mph_qa_dt", "udt": "mph_udt",
        "vdt": "mph_vdt",
    }

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            name: VarSpec(serialname=serial, microph=True)
            for name, serial in self.IN3.items()
        }
        self.in_vars["land"] = VarSpec(serialname="mph_land",
                                       microph=True)
        self.out_vars = {
            name: VarSpec(serialname=serial, microph=True)
            for name, serial in self.OUT.items()
        }

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.IN3
             if name not in ("delprsi", "wmp")}
        d["delprsi"] = s1["delp"]
        d["wmp"] = s1["w"]
        d["land"] = np.zeros(s1["ps"].shape)
        return d

    def run(self, t):
        from pace_torch.models.physics.microphysics import (
            Microphysics,
            MicrophysicsState,
        )

        state = MicrophysicsState(
            pt=t["pt"], qvapor=t["qvapor"], qliquid=t["qliquid"],
            qrain=t["qrain"], qice=t["qice"], qsnow=t["qsnow"],
            qgraupel=t["qgraupel"], qcld=t["qcld"], ua=t["ua"], va=t["va"],
            delp=t["delprsi"], delz=t["delz"],
            omga=torch.zeros_like(t["pt"]), delprsi=t["delprsi"],
            wmp=t["wmp"], dz=t["delz"], land=t["land"],
        )
        mp = Microphysics(self.phys_config, self.gd.horizontal.area,
                          timestep=225.0, device=self.device)
        out = mp(state)
        return {name: out[name] for name in self.OUT}


@register("GFSPhysicsDriver")
class TranslateGFSPhysicsDriver(BasePhysCase):
    """reference translate_gfs_physics_driver.py: the whole Physics
    driver call (statein -> prs/phi -> microphysics -> updated
    prognostics as IPD_g*0 blocks)."""

    DYCORE = GFS_TRACERS + ("pt", "delp", "delz", "ua", "va", "w",
                            "omga")
    OUT = {
        "gt0": "IPD_gt0", "gu0": "IPD_gu0", "gv0": "IPD_gv0",
        "qvapor": "IPD_qvapor", "qliquid": "IPD_qliquid",
        "qrain": "IPD_rain", "qice": "IPD_qice", "qsnow": "IPD_snow",
        "qgraupel": "IPD_qgraupel", "qcld": "IPD_qcld",
    }
    # output name -> PhysicsState field
    FIELDS = {
        "gt0": "physics_updated_pt", "gu0": "physics_updated_ua",
        "gv0": "physics_updated_va",
        "qvapor": "physics_updated_specific_humidity",
        "qliquid": "physics_updated_qliquid",
        "qrain": "physics_updated_qrain", "qice": "physics_updated_qice",
        "qsnow": "physics_updated_qsnow",
        "qgraupel": "physics_updated_qgraupel",
        "qcld": "physics_updated_cloud_fraction",
    }

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {name: VarSpec() for name in self.DYCORE}
        self.out_vars = {
            name: VarSpec(serialname=serial, phys_order="F")
            for name, serial in self.OUT.items()
        }

    def make_inputs(self, s0, s1, gd):
        d = {name: s1[name] for name in self.DYCORE if name in s1}
        d["qo3mr"] = np.zeros(s1["pt"].shape)
        d["qsgs_tke"] = np.zeros(s1["pt"].shape)
        return d

    def run(self, t):
        from pace_torch.models.physics.physics import Physics

        state = self._physics_state({k: t[k] for k in self.DYCORE})
        phys = Physics(self.phys_config, self.gd.horizontal.area,
                       _ptop(self.gd), timestep=225.0, device=self.device)
        out = phys(state)
        return {name: getattr(out, field)
                for name, field in self.FIELDS.items()}


@register("FVUpdatePhys")
class TranslateFVUpdatePhys(BasePhysCase, _TracersMixin):
    """reference translate_fv_update_phys.py TranslateFVUpdatePhys:
    apply physics tendencies back to the D-grid dycore state (multi-
    rank: includes the u_dt/v_dt halo update + A->D projection)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        h = self.h
        self.in_vars = {
            "u_dt": VarSpec(), "v_dt": VarSpec(), "t_dt": VarSpec(),
            "ua": VarSpec(), "va": VarSpec(), "u": VarSpec(),
            "v": VarSpec(),
        }
        for name in self.TRACERS[:6]:
            self.in_vars[name] = VarSpec()
        self.in_vars["peln"] = VarSpec(istart=h, jstart=h, kaxis=1)
        self.in_vars["delp"] = VarSpec()
        self.in_vars["pt"] = VarSpec()
        self.in_vars["ps"] = VarSpec()
        self.in_vars["pe"] = VarSpec(istart=h - 1, jstart=h - 1,
                                     kaxis=1)
        self.in_vars["pk"] = VarSpec(istart=h, jstart=h)
        self.in_vars["dt"] = VarSpec()
        self.out_vars = {
            name: VarSpec() for name in self.TRACERS[:6]
        }
        for name in ("pt", "u", "v", "ua", "va"):
            self.out_vars[name] = VarSpec()
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        d = {name: s1[name] for name in self.TRACERS[:6]}
        d.update(
            u_dt=smooth_field(shape3, 41, 1e-4),
            v_dt=smooth_field(shape3, 42, 1e-4),
            t_dt=smooth_field(shape3, 43, 1e-5),
            ua=s1["ua"], va=s1["va"], u=s1["u"], v=s1["v"],
            peln=s1["peln"], delp=s1["delp"], pt=s1["pt"],
            ps=s1["ps"], pe=s1["pe"], pk=s1["pk"], dt=225.0,
        )
        return d

    def run(self, t):
        from pace_torch.models.coupler.fv_update_phys import (
            apply_physics_to_dycore,
        )

        s = {name: t[name] for name in
             self.TRACERS[:6] + ("u", "v", "ua", "va", "pt", "pe", "peln",
                                 "pk", "ps", "delp")}
        s, _u_srf, _v_srf = apply_physics_to_dycore(
            s, t["u_dt"], t["v_dt"], t["t_dt"], self.gd,
            get_topology(self.n, self.h), c2l_order=4,
            dt=float(t["dt"]),
        )
        return {name: s[name] for name in self.out_vars}


@register("Driver")
class TranslateDriver(TranslateFVDynamics):
    """reference physics translate_driver.py TranslateDriver: ONE
    coupled dycore+physics step validated end-to-end (the reference
    builds a full Driver with the 'predefined' initializer; max_error
    3e-5).  Inherits the FVDynamics savepoint variable set."""

    max_error = 3e-5

    def run(self, t):
        from pace_torch.models.coupler import (
            DycoreToPhysics,
            UpdateAtmosphereState,
        )
        from pace_torch.models.fv3.dynamics import DynamicalCore
        from pace_torch.models.physics.physics import Physics

        dt = float(t["bdt"])
        core = DynamicalCore(self.config, self.sizing, self.gd, timestep=dt)
        physics = Physics(
            PhysicsConfig(npz=self.sizing.nz, dt_atmos=dt),
            self.gd.horizontal.area, _ptop(self.gd), dt, device=self.device)
        d2p = DycoreToPhysics(self.sizing, dtype=self.torch_dtype,
                              device=self.device)
        update = UpdateAtmosphereState(self.gd, core.topo, self.sizing, dt,
                                       device=self.device)
        state = core.step_dynamics(_dycore_state(t))
        out = update(state, physics(d2p(state)))
        return {name: getattr(out, name) for name in self.out_vars}


@register("UpdateDWindsPhys")
class TranslateUpdateDWindsPhys(BasePhysCase):
    """reference stencils translate_update_dwind_phys.py
    TranslateUpdateDWindsPhys: A-grid wind tendencies projected onto the
    D-grid winds (AGrid2DGridPhysics; here
    models/coupler/update_dwind_phys.py update_dwind_phys)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_vars = {
            "u": VarSpec(), "u_dt": VarSpec(),
            "v": VarSpec(), "v_dt": VarSpec(),
            "dt": VarSpec(),
        }
        self.out_vars = {"u": VarSpec(), "v": VarSpec()}
        self.stagger = {"u": (0, 1), "v": (1, 0)}

    def make_inputs(self, s0, s1, gd):
        shape3 = s1["pt"].shape
        return {
            "u": s1["u"], "v": s1["v"],
            "u_dt": smooth_field(shape3, 71, 1e-4),
            "v_dt": smooth_field(shape3, 72, 1e-4),
            "dt": 225.0,
        }

    def run(self, t):
        from pace_torch.models.coupler.update_dwind_phys import (
            update_dwind_phys,
        )

        u, v = update_dwind_phys(
            t["u"], t["v"], t["u_dt"], t["v_dt"], self.gd,
            get_topology(self.n, self.h), float(t["dt"]))
        return {"u": u, "v": v}
