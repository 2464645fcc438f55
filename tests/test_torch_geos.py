"""The dycore's second entry point in the port: the Fortran namelist
(`pace_torch.utils.namelist`) read as the reference reads it, and the GEOS
wrapper (`pace_torch.models.fv3.geos_wrapper`) stepping the same state as
the port's DynamicalCore, after tests/test_geos_wrapper.py."""

import dataclasses

import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads

INPUT_NML = """
&coupler_nml
    dt_atmos = 450
    days = 1   ! a comment
/
&fv_core_nml
    layout = 1,
             1
    npx = 49
    npy = 49
    npz = 79
    hydrostatic = .false.
    k_split = 2
    n_split = 6
    d4_bg = 0.15D0
    dddmp = 2.e-1
    hord_tr = 10
    kord_tm = -10
    do_sat_adj = .T.
    fill = .true.
    made_up_key = 'ignored'
/
&gfdl_cloud_microphysics_nml
    tau_l2v = 225.
/
"""

# tests/test_geos_wrapper.py's namelist, with hord_tr 6, whose plain
# transport costs half of the default 8's on a CPU
GEOS_NML = {"fv_core_nml": {"npx": 13, "npy": 13, "npz": 79,
                            "do_sat_adj": False, "dt_atmos": 225,
                            "hord_tr": 6}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


def test_namelist_maps_as_the_reference(tmp_path):
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.utils.namelist import Namelist, parse_namelist
    from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefConfig
    from pace_tpu.utils.namelist import Namelist as RefNamelist
    from pace_tpu.utils.namelist import parse_namelist as ref_parse

    assert parse_namelist(INPUT_NML) == ref_parse(INPUT_NML)
    path = tmp_path / "input.nml"
    path.write_text(INPUT_NML)
    port, ref = Namelist.from_file(str(path)), RefNamelist.from_file(
        str(path))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.npx, port.k_split, port.kord_tm, port.dt_atmos,
            port.layout) == (49, 2, -10, 450, (1, 1))
    kwargs = port.dycore_config_kwargs()
    assert kwargs == ref.dycore_config_kwargs()
    assert dataclasses.asdict(DynamicalCoreConfig(**kwargs)) == \
        dataclasses.asdict(RefConfig(**ref.dycore_config_kwargs()))


def test_geos_wrapper_steps_as_the_dycore():
    """One wrapper call on numpy arrays gives exactly what a DynamicalCore
    step gives on the same state (float32, the wrapper's default dtype),
    and the reference test's physical checks hold."""
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.geos_wrapper import (
        _IN_FIELDS,
        GeosDycoreWrapper,
    )
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.models.fv3.state import TRACER_NAMES
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.utils.namelist import Namelist

    wrapper = GeosDycoreWrapper(GEOS_NML, device="cpu")
    sizing = GridSizing(12, 79)
    state = init_baroclinic_state(sizing, device="cpu", dtype=torch.float32)
    fields = {name: getattr(state, name).numpy() for name in _IN_FIELDS}
    q = np.stack([getattr(state, name).numpy() for name in TRACER_NAMES], -1)
    out = wrapper(q, **fields)
    assert set(out) == set(fields) | {"q"}

    config = DynamicalCoreConfig(
        **Namelist.from_f90nml(GEOS_NML).dycore_config_kwargs())
    assert not config.do_sat_adj and wrapper.dycore_config == config
    core = DynamicalCore(config, sizing, wrapper.dycore.grid_data, 225.0)
    want = core.step_dynamics(state)
    for name in _IN_FIELDS:
        np.testing.assert_array_equal(out[name], getattr(want, name).numpy(),
                                      err_msg=name)
    for i, name in enumerate(TRACER_NAMES):
        np.testing.assert_array_equal(out["q"][..., i],
                                      getattr(want, name).numpy())

    h, n = 3, 12
    interior = out["pt"][:, h:h + n, h:h + n]
    assert np.isfinite(interior).all()
    assert 150.0 < interior.min() and interior.max() < 350.0
    assert np.abs(out["va"][:, h:h + n, h:h + n]).max() < 1.0
    assert set(wrapper.perf_collector.timestep_timer.times) == {
        "move_to_pace", "dycore", "move_to_fortran"}
