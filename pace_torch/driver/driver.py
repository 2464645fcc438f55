"""The model driver: configuration, initialization and the time loop.

Port of `pace_tpu.driver.driver` (reference ai2cm/pace
driver/pace/driver/driver.py `DriverConfig`, `Driver`).  One model step is
the dycore step, then (unless `dycore_only` or `disable_step_physics`) the
dry convective adjustment of the sponge layers, `DycoreToPhysics`,
`Physics` and `UpdateAtmosphereState`.  The step runs eagerly on the
driver's device: the card unless the caller asks for the CPU.

Sections of the reference package's configuration whose modules are not
ported raise `NotImplementedError` with the ROADMAP item that holds them.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from datetime import timedelta

import torch

from pace_torch.driver._from_dict import ConfigError, from_dict
from pace_torch.driver.initialization import InitializerSelector
from pace_torch.driver.state import DriverState
from pace_torch.grid.generation import generate_grid_data
from pace_torch.models.coupler import DycoreToPhysics, UpdateAtmosphereState
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.models.fv3.dynamics import DynamicalCore
from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.models.physics.physics import Physics
from pace_torch.ops.fv_subgridz import dry_convective_adjustment
from pace_torch.utils.gridtools import GridSizing

# sections of the reference package's DriverConfig that the port does not
# have yet, with the ROADMAP queue item that holds each
UNPORTED_SECTIONS = {
    "diagnostics_config": "ROADMAP Queue 1 item 10 (diagnostics)",
    "restart_config": "ROADMAP Queue 1 item 10 (restart)",
    "performance_config": "ROADMAP Queue 1 item 10 (performance)",
    "safety_check_frequency": "ROADMAP Queue 1 item 10 (safety checks)",
}


# sections that describe the device mesh and the generated grid: the port
# runs one device on the unstretched grid, so each key is accepted only at
# the reference package's default
MESH_DEFAULTS = dict(layout=(1, 1, 1), multihost=False,
                     coordinator_address=None, num_processes=None,
                     process_id=None, dcn_mesh_shape=None)
GRID_DEFAULTS = dict(stretch_factor=None, lon_target=350.0, lat_target=-90.0,
                     eta_file=None)


def _only_defaults(name: str, section, defaults: dict, where: str) -> None:
    """Raises `ConfigError` for a key the reference package's section does
    not have, `NotImplementedError` for one that is not at its default."""
    if section is None:
        return
    if not isinstance(section, dict):
        raise ConfigError(f"{name}: expected mapping, "
                          f"got {type(section).__name__}")
    unknown = set(section) - set(defaults)
    if unknown:
        raise ConfigError(f"{name}: unknown keys {sorted(unknown)}; "
                          f"allowed: {sorted(defaults)}")
    for key, value in section.items():
        if isinstance(value, list):
            value = tuple(value)
        if value != defaults[key]:
            raise NotImplementedError(
                f"{name}.{key} = {value!r} is not ported: {where}")


def _drop_unported(kwargs: dict) -> dict:
    """kwargs without the sections that only say "one device, generated
    grid"; raises for a section whose module is not ported."""
    kwargs = dict(kwargs)
    for key, where in UNPORTED_SECTIONS.items():
        if kwargs.get(key) is not None:
            raise NotImplementedError(f"{key} is not ported: {where}")
        kwargs.pop(key, None)
    _only_defaults("mesh", kwargs.pop("mesh", None), MESH_DEFAULTS,
                   "ROADMAP Queue 1 item 11 (multi-GPU)")
    _only_defaults("grid_config", kwargs.pop("grid_config", None),
                   GRID_DEFAULTS,
                   "ROADMAP Queue 1 item 9 (stretched grid, eta files)")
    return kwargs


@dataclasses.dataclass
class DriverConfig:
    """Configuration for a model run (reference driver.py:46-210).

    Attributes:
        initialization: initial-condition selector
        nx_tile: gridpoints per horizontal tile dimension
        nz: vertical levels
        dt_atmos: timestep (s)
        dtype: "float32" or "float64"
    """

    initialization: InitializerSelector
    nx_tile: int
    nz: int
    dt_atmos: float
    dycore_config: DynamicalCoreConfig = dataclasses.field(
        default_factory=DynamicalCoreConfig
    )
    physics_config: PhysicsConfig = dataclasses.field(
        default_factory=PhysicsConfig
    )
    days: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    dycore_only: bool = False
    disable_step_physics: bool = False
    dtype: str = "float32"

    @functools.cached_property
    def timestep(self) -> timedelta:
        return timedelta(seconds=self.dt_atmos)

    @functools.cached_property
    def total_time(self) -> timedelta:
        return timedelta(days=self.days, hours=self.hours,
                         minutes=self.minutes, seconds=self.seconds)

    def n_timesteps(self) -> int:
        if self.total_time < self.timestep:
            warnings.warn(
                f"total time {self.total_time} < timestep {self.timestep}"
            )
        return int(self.total_time / self.timestep)

    @classmethod
    def from_dict(cls, kwargs: dict) -> "DriverConfig":
        """Strict: an unknown key raises `ConfigError`, a section of the
        reference package that is not ported `NotImplementedError`."""
        return from_dict(cls, _drop_unported(kwargs))


class Driver:
    def __init__(self, config: DriverConfig, device="cuda"):
        if config.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, "
                             f"got {config.dtype!r}")
        self.config = config
        self.device = torch.device(device)
        self.time = config.initialization.start_time
        dtype = getattr(torch, config.dtype)

        sizing = GridSizing(config.nx_tile, config.nz)
        grid_data = generate_grid_data(
            config.nx_tile, config.nz, device=self.device, dtype=dtype)
        dycore_state = config.initialization.get_dycore_state(
            sizing, self.device, dtype)
        self.state = DriverState(
            dycore_state=dycore_state, grid_data=grid_data, sizing=sizing,
            time=self.time,
        )
        self.dycore = DynamicalCore(
            config.dycore_config, sizing, grid_data, config.dt_atmos)
        if not (config.dycore_only or config.disable_step_physics):
            # a Python float, read once: the step never asks the device
            self._ptop = float(grid_data.vertical.ptop)
            self.physics = Physics(
                config.physics_config, grid_data.horizontal.area,
                self._ptop, config.dt_atmos, device=self.device,
            )
            self.dycore_to_physics = DycoreToPhysics(
                sizing, dtype=dtype, device=self.device)
            self.end_of_step_update = UpdateAtmosphereState(
                grid_data, self.dycore.topo, sizing, config.dt_atmos,
                c2l_order=config.dycore_config.c2l_ord, device=self.device,
            )
        else:
            self.physics = None
        self._step = self._build_step()

    @classmethod
    def from_dict(cls, kwargs: dict, device="cuda") -> "Driver":
        return cls(DriverConfig.from_dict(kwargs), device=device)

    def _build_step(self):
        dycore = self.dycore
        physics = self.physics
        cfg = self.config.dycore_config
        do_sg = cfg.fv_sg_adj > 0 and physics is not None

        def physics_step(state):
            u_dt0 = v_dt0 = None
            if do_sg:
                s = {f.name: getattr(state, f.name)
                     for f in dataclasses.fields(state)}
                s, u_dt0, v_dt0 = dry_convective_adjustment(
                    s, self.config.dt_atmos, cfg.fv_sg_adj,
                    cfg.n_sponge, nwat=cfg.nwat, ptop=self._ptop,
                )
                state = type(state)(**s)
            phy = self.dycore_to_physics(state)
            phy = physics(phy)
            return self.end_of_step_update(
                state, phy, u_dt0=u_dt0, v_dt0=v_dt0
            )

        def step(state):
            state = dycore.step_dynamics(state)
            if physics is not None:
                state = physics_step(state)
            return state

        self.physics_step = physics_step if physics is not None else None
        return step

    def step(self):
        """Advance the model state by one timestep."""
        self.state.dycore_state = self._step(self.state.dycore_state)
        self.time += self.config.timestep
        self.state.time = self.time

    def step_all(self):
        for _ in range(self.config.n_timesteps()):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
