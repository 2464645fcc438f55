"""Initial-condition providers.

Port of `pace_tpu.driver.initialization` (reference ai2cm/pace
driver/pace/driver/initialization.py): an Initializer ABC behind an
InitializerSelector hydrated from {"type": ..., "config": {...}}:
"baroclinic" (Jablonowski & Williamson 2006), "tropicalcyclone" (Reed &
Jablonowski), "restart" (a restart written by either package), "fortran_restart"
(the Fortran model's tile-sharded NetCDF restart files) and "predefined" (a
DycoreState built by the caller).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import os
from datetime import datetime
from typing import Optional

from pace_torch.driver._from_dict import ConfigError, from_dict
from pace_torch.models.fv3.state import DycoreState, zeros_numpy

logger = logging.getLogger("pace_torch.driver")


class Initializer(abc.ABC):
    @property
    @abc.abstractmethod
    def start_time(self) -> datetime:
        ...

    @abc.abstractmethod
    def get_dycore_state(self, sizing, device, dtype, part=None):
        """The initial DycoreState on `device` with `dtype`: the whole cube,
        or the block one rank holds (`part`, `Partition.part(rank)`),
        which is all a rank builds or reads."""


@dataclasses.dataclass
class BaroclinicInit(Initializer):
    """Jablonowski & Williamson baroclinic wave test case."""

    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype, part=None):
        from pace_torch.models.fv3.init.baroclinic import (
            init_baroclinic_state,
        )

        return init_baroclinic_state(sizing, device=device, dtype=dtype,
                                     part=part)


@dataclasses.dataclass
class TropicalCycloneConfig(Initializer):
    """Reed-Jablonowski tropical cyclone test case (FV3 test_case 55)."""

    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype, part=None):
        from pace_torch.models.fv3.init.tropical_cyclone import init_tc_state

        return init_tc_state(sizing, device=device, dtype=dtype, part=part)


@dataclasses.dataclass
class RestartInit(Initializer):
    """Start from a restart directory written by either package."""

    path: str = "RESTART"
    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype, part=None):
        from pace_torch.driver.restart import load_restart_arrays

        return DycoreState.from_numpy(load_restart_arrays(self.path, part),
                                      device, dtype)


@dataclasses.dataclass
class FortranRestartInit(Initializer):
    """Start from the Fortran model's `.res` tile restart files
    (fv_core.res.tile*.nc etc.; reference driver/pace/driver/
    initialization.py:225 FortranRestartInit), read by
    utils/legacy_restart.open_restart.  Fields the files do not hold start
    at zero."""

    path: str = "RESTART"
    label: str = ""
    start_time_str: Optional[str] = None  # coupler.res wins when present

    @property
    def start_time(self) -> datetime:
        if self.start_time_str is not None:
            return datetime.fromisoformat(self.start_time_str)
        from pace_torch.utils.legacy_restart import (
            COUPLER_RES_NAME,
            get_current_date_from_coupler_res,
        )

        coupler = os.path.join(self.path, COUPLER_RES_NAME)
        if os.path.exists(coupler):
            return get_current_date_from_coupler_res(coupler)
        return datetime(2000, 1, 1)

    def get_dycore_state(self, sizing, device, dtype, part=None):
        from pace_torch.utils.legacy_restart import open_restart

        arrays = open_restart(self.path, sizing, label=self.label,
                              dtype=None, part=part)
        arrays.pop("time", None)
        # surface-wind diagnostics are not DycoreState fields
        arrays.pop("u_srf", None)
        arrays.pop("v_srf", None)
        return DycoreState.from_numpy(
            {**zeros_numpy(sizing, part), **arrays}, device, dtype)


@dataclasses.dataclass
class PredefinedStateInit(Initializer):
    """Start from an already-constructed DycoreState (reference
    driver/pace/driver/initialization.py:381 PredefinedStateInit), moved to
    the driver's device and dtype.  For programmatic use: a yaml file
    cannot hold the state."""

    dycore_state: object = None
    start_time_str: str = "2016-08-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype, part=None):
        if self.dycore_state is None:
            raise ValueError(
                "predefined initializer requires a dycore_state object"
            )
        # the state given is the whole cube: a rank cuts it
        cut = part.cut if part is not None else (lambda a: a)
        return DycoreState(**{
            f.name: cut(getattr(self.dycore_state, f.name)).to(
                device=device, dtype=dtype)
            for f in dataclasses.fields(DycoreState)
        })


REGISTERED = {
    "baroclinic": BaroclinicInit,
    "tropicalcyclone": TropicalCycloneConfig,
    "restart": RestartInit,
    "fortran_restart": FortranRestartInit,
    "predefined": PredefinedStateInit,
}


@dataclasses.dataclass
class InitializerSelector(Initializer):
    """Selector: {"type": "baroclinic", "config": {...}}."""

    type: str
    config: Initializer

    @property
    def start_time(self) -> datetime:
        return self.config.start_time

    def get_dycore_state(self, sizing, device, dtype, part=None):
        return self.config.get_dycore_state(sizing, device, dtype, part)

    @classmethod
    def from_dict(cls, config: dict):
        # as the reference's registry, read only `type` and `config`
        unknown = sorted(set(config) - {"type", "config"})
        if unknown:
            logger.warning("initialization: ignoring unknown keys %s",
                           unknown)
        type_name = config.get("type")
        if type_name is None:
            raise ConfigError("initialization: 'type' key required")
        if type_name not in REGISTERED:
            raise ConfigError(
                f"unknown initialization type {type_name!r}; registered: "
                f"{sorted(REGISTERED)}")
        instance = from_dict(REGISTERED[type_name], config.get("config", {}),
                             "initialization.config")
        return cls(type=type_name, config=instance)
