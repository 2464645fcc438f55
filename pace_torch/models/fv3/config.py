"""Dynamical-core configuration.

The same fields and defaults as `pace_tpu.models.fv3.config` (reference
ai2cm/pace fv3core/pace/fv3core/_config.py:155), and the per-level "column
namelist" damping parameters (d_sw.py:get_column_namelist).  As in the
reference package, `from_dict` drops an unknown key, with a warning that
names it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict

import numpy as np

logger = logging.getLogger("pace_torch.config")


@dataclasses.dataclass(frozen=True)
class DynamicalCoreConfig:
    npx: int = 13
    npy: int = 13
    npz: int = 79
    dt_atmos: float = 225.0
    a_imp: float = 1.0
    beta: float = 0.0
    consv_te: float = 0.0
    d2_bg: float = 0.0
    d2_bg_k1: float = 0.2
    d2_bg_k2: float = 0.1
    d4_bg: float = 0.15
    d_con: float = 1.0
    d_ext: float = 0.0
    dddmp: float = 0.5
    delt_max: float = 0.002
    do_sat_adj: bool = True
    do_vort_damp: bool = True
    fill: bool = True
    hord_dp: int = 6
    hord_mt: int = 6
    hord_tm: int = 6
    hord_tr: int = 8
    hord_vt: int = 6
    hydrostatic: bool = False
    k_split: int = 1
    ke_bg: float = 0.0
    kord_mt: int = 9
    kord_tm: int = -9
    kord_tr: int = 9
    kord_wz: int = 9
    n_split: int = 1
    nord: int = 3
    nwat: int = 6
    p_fac: float = 0.05
    rf_cutoff: float = 3000.0
    rf_fast: bool = True
    tau: float = 10.0
    vtdm4: float = 0.06
    z_tracer: bool = True
    # data-dependent tracer substep count from the in-graph global max
    # Courant number (restores the Fortran behavior the reference
    # commented out, tracer_2d_1l.py:312-338); False = fixed 3 substeps
    # exactly like the reference
    dynamic_tracer_subcycle: bool = False
    do_qa: bool = True
    n_sponge: int = 48
    fv_sg_adj: int = 0
    grid_type: int = 0
    do_f3d: bool = False
    inline_q: bool = False
    do_skeb: bool = False
    use_logp: bool = False
    moist_phys: bool = True
    check_negative: bool = False
    c2l_ord: int = 4
    m_split: int = 0
    convert_ke: bool = False
    breed_vortex_inline: bool = False
    use_old_omega: bool = True
    adiabatic: bool = False
    nf_omega: int = 1
    z_slope_ice: bool = True
    # saturation adjustment parameters (GFDL microphysics fast phase)
    sat_adj0: float = 0.9
    ql_gen: float = 1.0e-3
    ql_mlt: float = 2.0e-3
    qs_mlt: float = 1.0e-6
    ql0_max: float = 2.0e-3
    t_sub: float = 184.0
    qi_gen: float = 1.82e-6
    qi_lim: float = 1.0
    qi0_max: float = 1.0e-4
    rad_snow: bool = True
    rad_rain: bool = True
    rad_graupel: bool = True
    tintqs: bool = False
    dw_ocean: float = 0.1
    dw_land: float = 0.15
    icloud_f: int = 0
    cld_min: float = 0.05
    tau_i2s: float = 1000.0
    tau_v2l: float = 90.0
    tau_r2g: float = 900.0
    tau_l2r: float = 900.0
    tau_l2v: float = 300.0
    tau_imlt: float = 600.0
    tau_smlt: float = 900.0
    tau_g2r: float = 600.0
    tau_g2v: float = 1200.0
    tau_v2g: float = 21600.0

    @property
    def do_dry_convective_adjustment(self) -> bool:
        return self.fv_sg_adj > 0

    @classmethod
    def from_dict(cls, d: dict) -> "DynamicalCoreConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            logger.warning("dycore_config: ignoring unknown keys %s", unknown)
        return cls(**{k: v for k, v in d.items() if k in known})


def get_column_namelist(config: DynamicalCoreConfig, npz: int) -> Dict[str, np.ndarray]:
    """Per-level damping parameter columns (reference d_sw.py:571-617)."""
    col = {
        name: np.zeros(npz)
        for name in [
            "ke_bg", "d_con", "nord", "nord_v", "nord_w", "nord_t",
            "damp_vt", "damp_w", "damp_t", "d2_divg",
        ]
    }
    col["ke_bg"][:] = config.ke_bg
    col["d_con"][:] = config.d_con
    col["nord"][:] = config.nord
    col["d2_divg"][:] = min(0.2, config.d2_bg)
    col["nord_v"][:] = min(2, config.nord)
    col["nord_w"][:] = col["nord_v"][0]
    col["nord_t"][:] = col["nord_v"][0]
    col["damp_vt"][:] = config.vtdm4 if config.do_vort_damp else 0.0
    col["damp_w"][:] = col["damp_vt"][0]
    col["damp_t"][:] = col["damp_vt"][0]

    def set_low_kvals(k):
        for name in ["nord", "nord_w", "d_con"]:
            col[name][k] = 0
        col["damp_w"][k] = col["d2_divg"][k]

    def vorticity_damping_option(k):
        if config.do_vort_damp:
            col["nord_v"][k] = 0
            col["damp_vt"][k] = 0.5 * col["d2_divg"][k]

    if npz == 1 or config.n_sponge < 0:
        col["d2_divg"][0] = config.d2_bg
    else:
        col["d2_divg"][0] = max(0.01, config.d2_bg, config.d2_bg_k1)
        set_low_kvals(0)
        vorticity_damping_option(0)
        if config.d2_bg_k2 > 0.01:
            col["d2_divg"][1] = max(config.d2_bg, config.d2_bg_k2)
            set_low_kvals(1)
            vorticity_damping_option(1)
        if config.d2_bg_k2 > 0.05:
            col["d2_divg"][2] = max(config.d2_bg, 0.2 * config.d2_bg_k2)
            set_low_kvals(2)
    return col
