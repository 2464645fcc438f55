"""Physics configuration.

The same fields and defaults as `pace_tpu.models.physics.config` (reference
ai2cm/pace physics/pace/physics/_config.py:14-100 `PhysicsConfig`, default
values from util/pace/util/namelist.py:12-107).  Plain dataclass defaults;
the driver hydrates it from a dict.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from pace_torch.models.physics.emulator import MLPEmulatorConfig


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    dt_atmos: float = 225.0
    # "gfdl" (the full 6-category scheme) or "emulator" (the ML column
    # MLP, models/physics/emulator.py)
    microphysics_scheme: str = "gfdl"
    emulator: MLPEmulatorConfig = dataclasses.field(
        default_factory=MLPEmulatorConfig
    )
    hydrostatic: bool = False
    npx: int = 13
    npy: int = 13
    npz: int = 79
    nwat: int = 6
    do_qa: bool = True
    c_cracw: float = 0.8  # rain accretion efficiency
    c_paut: float = 0.5  # autoconversion cloud water -> rain
    c_pgacs: float = 0.01  # snow -> graupel accretion efficiency
    c_psaci: float = 0.05  # accretion: cloud ice -> snow
    ccn_l: float = 300.0  # CCN over land (cm^-3)
    ccn_o: float = 100.0  # CCN over ocean (cm^-3)
    const_vg: bool = False
    const_vi: bool = False
    const_vr: bool = False
    const_vs: bool = False
    vs_fac: float = 1.0
    vg_fac: float = 1.0
    vi_fac: float = 1.0
    vr_fac: float = 1.0
    de_ice: bool = False
    layout: Tuple[int, int] = (1, 1)
    # gfdl_cloud_microphys.F90 time scales
    tau_imlt: float = 600.0  # cloud ice melting
    tau_i2s: float = 1000.0  # cloud ice -> snow autoconversion
    tau_g2v: float = 1200.0  # graupel sublimation
    tau_v2g: float = 21600.0  # graupel deposition (slow)
    tau_l2v: float = 300.0  # cloud water evaporation
    ql_mlt: float = 2.0e-3  # max cloud water from melted cloud ice
    qs_mlt: float = 1.0e-6  # max cloud water due to snow melt
    t_sub: float = 184.0  # min temp for cloud ice sublimation
    qi_gen: float = 1.82e-6  # max cloud ice generation during remapping
    qi_lim: float = 1.0  # cloud ice limiter
    qi0_max: float = 1.0e-4  # max cloud ice value (other sources)
    rad_snow: bool = True  # snow in cloud fraction calculation
    rad_rain: bool = True  # rain in cloud fraction calculation
    dw_ocean: float = 0.10  # base subgrid variability over ocean
    dw_land: float = 0.15  # base subgrid variability over land
    c2l_ord: int = 4
    do_sedi_heat: bool = False
    do_sedi_w: bool = True
    fast_sat_adj: bool = True
    qc_crt: float = 5.0e-8  # min condensate for partial cloudiness
    fix_negative: bool = True
    irain_f: int = 0
    mp_time: float = 225.0  # max microphysics sub-timestep (s)
    prog_ccn: bool = False
    qi0_crt: float = 8.0e-5  # cloud ice -> snow autoconversion threshold
    qs0_crt: float = 3.0e-3  # snow -> graupel density threshold
    rh_inc: float = 0.2
    rh_inr: float = 0.3
    rthresh: float = 1.0e-5  # critical cloud drop radius (micrometers)
    sedi_transport: bool = True
    use_ppm: bool = False
    vg_max: float = 16.0
    vi_max: float = 1.0
    vr_max: float = 16.0
    vs_max: float = 2.0
    z_slope_ice: bool = True
    z_slope_liq: bool = True
    tice: float = 273.16
    alin: float = 842.0  # "a" in lin 1983
    clin: float = 4.8  # "c" in lin 1983
