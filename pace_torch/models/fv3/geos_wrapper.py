"""Host-model embedding interface (GEOS wrapper).

Port of `pace_tpu.models.fv3.geos_wrapper` (reference ai2cm/pace
fv3core/pace/fv3core/initialization/geos_wrapper.py `GeosDycoreWrapper`):
lets a host model (e.g. NASA GEOS) drive one dycore step at a time with
plain numpy arrays — namelist in, numpy state in, numpy state out.  The
tracer bundle `q` carries the 9 advected species on a trailing axis, as in
the Fortran interface.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from pace_torch.driver.performance import PerformanceCollector
from pace_torch.grid.generation import generate_grid_data
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.models.fv3.dynamics import DynamicalCore
from pace_torch.models.fv3.state import TRACER_NAMES, DycoreState, zeros_numpy
from pace_torch.utils.gridtools import GridSizing
from pace_torch.utils.host import to_host
from pace_torch.utils.namelist import Namelist

_IN_FIELDS = (
    "u", "v", "w", "delz", "pt", "delp", "ps", "pe", "pk", "peln", "pkz",
    "phis", "q_con", "omga", "ua", "va", "uc", "vc", "mfxd", "mfyd",
    "cxd", "cyd", "diss_estd",
)


class GeosDycoreWrapper:
    """numpy-in / numpy-out single-step dycore driver for host models, on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, namelist: Union[Namelist, dict, str],
                 dtype=torch.float32, device="cuda"):
        if isinstance(namelist, str):
            namelist = Namelist.from_file(namelist)
        elif isinstance(namelist, dict):
            namelist = Namelist.from_f90nml(namelist)
        self.namelist = namelist
        self.perf_collector = PerformanceCollector("GEOS wrapper", device)
        self.dycore_config = DynamicalCoreConfig(
            **namelist.dycore_config_kwargs()
        )
        n = namelist.npx - 1
        self.sizing = GridSizing(n, namelist.npz)
        grid_data = generate_grid_data(n, namelist.npz, device=device,
                                       dtype=dtype)
        self.dycore = DynamicalCore(
            self.dycore_config, self.sizing, grid_data,
            timestep=float(namelist.dt_atmos),
        )
        self.dycore_state = DycoreState.from_numpy(
            zeros_numpy(self.sizing), grid_data.device, dtype)

    def _put_fortran_data_in_dycore(self, q: np.ndarray,
                                    **fields) -> DycoreState:
        state = self.dycore_state
        kw = {name: getattr(state, name)
              for name in state.__dataclass_fields__}
        for name, arr in fields.items():
            kw[name] = torch.as_tensor(np.asarray(arr), dtype=state.dtype,
                                       device=state.device)
        for i, name in enumerate(TRACER_NAMES):
            if i < q.shape[-1]:
                kw[name] = torch.as_tensor(q[..., i], dtype=state.dtype,
                                           device=state.device)
        return DycoreState(**kw)

    def _prep_outputs_for_geos(self) -> Dict[str, np.ndarray]:
        s = self.dycore_state
        host = to_host({name: getattr(s, name)
                        for name in _IN_FIELDS + TRACER_NAMES})
        out = {name: host[name] for name in _IN_FIELDS}
        out["q"] = np.stack([host[name] for name in TRACER_NAMES], -1)
        return out

    def __call__(self, q: np.ndarray, **fields) -> Dict[str, np.ndarray]:
        """Run one dycore step.  `fields` are the _IN_FIELDS numpy arrays
        (any omitted field keeps its previous value); `q` is
        (..., n_tracers)."""
        timer = self.perf_collector.timestep_timer
        with timer.clock("move_to_pace"):
            self.dycore_state = self._put_fortran_data_in_dycore(q, **fields)
        with timer.clock("dycore"):
            self.dycore_state = self.dycore.step_dynamics(self.dycore_state)
        with timer.clock("move_to_fortran"):
            return self._prep_outputs_for_geos()
