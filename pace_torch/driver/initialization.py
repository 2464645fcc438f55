"""Initial-condition providers.

Port of `pace_tpu.driver.initialization` (reference ai2cm/pace
driver/pace/driver/initialization.py): an Initializer ABC behind an
InitializerSelector hydrated from {"type": ..., "config": {...}}:
"baroclinic" (Jablonowski & Williamson 2006), "tropicalcyclone" (Reed &
Jablonowski), "restart" (a restart written by either package) and
"predefined" (a DycoreState built by the caller).  "fortran_restart" raises
`NotImplementedError`.
"""

from __future__ import annotations

import abc
import dataclasses
from datetime import datetime

from pace_torch.driver._from_dict import ConfigError, from_dict
from pace_torch.models.fv3.state import DycoreState

# initialisation types of the reference package that the port does not have
# yet, with the ROADMAP queue item that holds each
UNPORTED_TYPES = {
    "fortran_restart": "ROADMAP Queue 1 item 10 (legacy restart files, "
                       "utils/legacy_restart.py)",
}


class Initializer(abc.ABC):
    @property
    @abc.abstractmethod
    def start_time(self) -> datetime:
        ...

    @abc.abstractmethod
    def get_dycore_state(self, sizing, device, dtype):
        ...


@dataclasses.dataclass
class BaroclinicInit(Initializer):
    """Jablonowski & Williamson baroclinic wave test case."""

    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype):
        from pace_torch.models.fv3.init.baroclinic import (
            init_baroclinic_state,
        )

        return init_baroclinic_state(sizing, device=device, dtype=dtype)


@dataclasses.dataclass
class TropicalCycloneConfig(Initializer):
    """Reed-Jablonowski tropical cyclone test case (FV3 test_case 55)."""

    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype):
        from pace_torch.models.fv3.init.tropical_cyclone import init_tc_state

        return init_tc_state(sizing, device=device, dtype=dtype)


@dataclasses.dataclass
class RestartInit(Initializer):
    """Start from a restart directory written by either package."""

    path: str = "RESTART"
    start_time_str: str = "2000-01-01 00:00:00"

    @property
    def start_time(self) -> datetime:
        return datetime.fromisoformat(self.start_time_str)

    def get_dycore_state(self, sizing, device, dtype):
        from pace_torch.driver.restart import load_restart_arrays

        return DycoreState.from_numpy(load_restart_arrays(self.path),
                                      device, dtype)


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

    def get_dycore_state(self, sizing, device, dtype):
        if self.dycore_state is None:
            raise ValueError(
                "predefined initializer requires a dycore_state object"
            )
        return DycoreState(**{
            f.name: getattr(self.dycore_state, f.name).to(device=device,
                                                          dtype=dtype)
            for f in dataclasses.fields(DycoreState)
        })


REGISTERED = {
    "baroclinic": BaroclinicInit,
    "tropicalcyclone": TropicalCycloneConfig,
    "restart": RestartInit,
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

    def get_dycore_state(self, sizing, device, dtype):
        return self.config.get_dycore_state(sizing, device, dtype)

    @classmethod
    def from_dict(cls, config: dict):
        unknown = sorted(set(config) - {"type", "config"})
        if unknown:
            raise ConfigError(f"initialization: unknown keys {unknown}")
        type_name = config.get("type")
        if type_name is None:
            raise ConfigError("initialization: 'type' key required")
        if type_name in UNPORTED_TYPES:
            raise NotImplementedError(
                f"initialization type {type_name!r} is not ported: "
                f"{UNPORTED_TYPES[type_name]}")
        if type_name not in REGISTERED:
            raise ConfigError(
                f"unknown initialization type {type_name!r}; registered: "
                f"{sorted(REGISTERED)}")
        instance = from_dict(REGISTERED[type_name], config.get("config", {}),
                             "initialization.config")
        return cls(type=type_name, config=instance)
