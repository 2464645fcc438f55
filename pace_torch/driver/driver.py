"""The model driver: configuration, initialization, time loop, output.

Port of `pace_tpu.driver.driver` (reference ai2cm/pace
driver/pace/driver/driver.py `DriverConfig`, `Driver`).  One model step is
the dycore step, then (unless `dycore_only` or `disable_step_physics`) the
dry convective adjustment of the sponge layers, `DycoreToPhysics`,
`Physics` and `UpdateAtmosphereState`.  The step runs eagerly on the
driver's device: the card unless the caller asks for the CPU.  `step_all`
adds the reference package's cadence of diagnostics, safety checks and
intermediate restarts; `cleanup` writes the performance report, the grid
and the final restart.

The configuration is the reference package's, key for key, so every yaml
file it reads hydrates here.  A `mesh` layout `(t, x, y)` runs `t x y`
ranks (processes started by `torchrun`, or by the caller with
`multihost`), each owning a box of `6 / t` tiles, `1 / x` of each along i
and `1 / y` along j (parallel/partition.py; every box at least the halo's
width): each rank builds and steps its block, the halo updates exchange
between ranks (parallel/halo.py `RankTopology`), and diagnostics, restarts
and the performance report are gathered to rank 0 and written once, the
files of a one-rank run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import warnings
from datetime import timedelta
from typing import Optional, Tuple

import torch

from pace_torch.driver import diagnostics as diag_mod
from pace_torch.driver._from_dict import from_dict
from pace_torch.driver.initialization import InitializerSelector
from pace_torch.driver.performance import NullProfiler, PerformanceConfig
from pace_torch.driver.restart import RestartConfig
from pace_torch.driver.safety_checks import (
    SafetyChecker,
    register_default_checks,
)
from pace_torch.driver.state import DriverState
from pace_torch.grid.generation import generate_grid_data
from pace_torch.models.coupler import DycoreToPhysics, UpdateAtmosphereState
from pace_torch.models.fv3.config import DynamicalCoreConfig
from pace_torch.models.fv3.dynamics import DynamicalCore
from pace_torch.models.physics.config import PhysicsConfig
from pace_torch.models.physics.physics import Physics
from pace_torch.ops.fv_subgridz import dry_convective_adjustment
from pace_torch.parallel import comm as comm_mod
from pace_torch.parallel.halo import RankTopology
from pace_torch.parallel.partition import Partition, check_layout
from pace_torch.utils import constants
from pace_torch.utils.gridtools import GridSizing

logger = logging.getLogger("pace_torch.driver")


@dataclasses.dataclass
class MeshConfig:
    """Rank layout over (tile, x, y), as the reference package's device
    mesh; the tile count divides 6 and `dcn_mesh_shape` (the hosts' grid)
    divides the layout elementwise, ranks numbered host-major.

    Multi-host: `multihost: true` starts the process group from
    `coordinator_address` (host:port of rank 0), `num_processes` and
    `process_id`, or, without a coordinator address, from the environment
    `torchrun` sets (`env://`), as a one-host run of more than one rank
    does."""

    layout: Tuple[int, int, int] = (1, 1, 1)
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    dcn_mesh_shape: Optional[Tuple[int, int, int]] = None

    @property
    def ranks(self) -> int:
        t, x, y = check_layout(self.layout, self.dcn_mesh_shape)
        return t * x * y

    def build(self, n: int, halo: int, device):
        """Validate the layout and, for more than one rank, join (or start)
        the process group: returns (Partition, Comm), or None for one
        rank.  A layout whose boxes are narrower than the halo raises
        ValueError before any process group is joined."""
        layout = check_layout(self.layout, self.dcn_mesh_shape)
        Partition(layout, n, halo, self.dcn_mesh_shape)
        ranks = self.ranks
        if ranks == 1 and not self.multihost:
            return None
        if self.multihost and self.coordinator_address is not None:
            if self.num_processes is None or self.process_id is None:
                raise ValueError("multihost with a coordinator_address needs "
                                 "num_processes and process_id")
            comm = comm_mod.init_process_group(
                device, f"tcp://{self.coordinator_address}",
                self.num_processes, self.process_id)
        else:
            comm = comm_mod.init_process_group(device)
        if comm.size != ranks:
            raise ValueError(f"mesh layout {list(layout)} needs {ranks} "
                             f"ranks, the process group has {comm.size}")
        if ranks == 1:
            return None
        return Partition(layout, n, halo, self.dcn_mesh_shape), comm


@dataclasses.dataclass
class GridConfig:
    """Generated-grid options (reference driver/pace/driver/grid.py:82
    GeneratedGridConfig): Schmidt stretching and vertical-table override."""

    stretch_factor: Optional[float] = None
    lon_target: float = 350.0
    lat_target: float = -90.0
    eta_file: Optional[str] = None


@dataclasses.dataclass
class DriverConfig:
    """Configuration for a model run (reference driver.py:46-210).

    Attributes:
        initialization: initial-condition selector
        nx_tile: gridpoints per horizontal tile dimension
        nz: vertical levels
        dt_atmos: timestep (s)
        mesh: rank layout over (tile, x, y)
        grid_config: stretched-grid / eta-file options
        dtype: "float32" or "float64"
    """

    initialization: InitializerSelector
    nx_tile: int
    nz: int
    dt_atmos: float
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    grid_config: GridConfig = dataclasses.field(default_factory=GridConfig)
    diagnostics_config: diag_mod.DiagnosticsConfig = dataclasses.field(
        default_factory=diag_mod.DiagnosticsConfig
    )
    performance_config: PerformanceConfig = dataclasses.field(
        default_factory=PerformanceConfig
    )
    dycore_config: DynamicalCoreConfig = dataclasses.field(
        default_factory=DynamicalCoreConfig
    )
    physics_config: PhysicsConfig = dataclasses.field(
        default_factory=PhysicsConfig
    )
    restart_config: RestartConfig = dataclasses.field(
        default_factory=RestartConfig
    )
    days: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    dycore_only: bool = False
    disable_step_physics: bool = False
    safety_check_frequency: Optional[int] = None
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
        """Strict: an unknown key raises `ConfigError`."""
        return from_dict(cls, kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "DriverConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


class Driver:
    def __init__(self, config: DriverConfig, device="cuda"):
        if config.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, "
                             f"got {config.dtype!r}")
        self.config = config
        # a rank of several on "cuda" runs on cuda:LOCAL_RANK
        self.device = (comm_mod.rank_device(device)
                       if config.mesh.ranks > 1 else torch.device(device))
        # (Partition, Comm) of a multi-rank run, else None
        self.ranks = config.mesh.build(config.nx_tile,
                                       constants.N_HALO_DEFAULT, self.device)
        self.partition, self.comm = self.ranks or (None, None)
        self.rank = 0 if self.comm is None else self.comm.rank
        self.time = config.initialization.start_time
        perf = config.performance_config
        self.performance_collector = perf.build(self.device)
        # one trace: rank 0's
        self.profiler = (perf.build_profiler(self.device) if self.rank == 0
                         else NullProfiler())
        dtype = getattr(torch, config.dtype)

        with self.performance_collector.total_timer.clock("initialization"):
            if self.device.type == "cuda":
                # the kernels build (nvcc) or load here, so that the first
                # step's time holds none of it
                from pace_torch.ops import _cuda

                info = _cuda.build()
                _cuda.library()
                logger.info("CUDA kernels: %s (built in %.1f s)",
                            info.path, info.seconds)
            sizing = GridSizing(config.nx_tile, config.nz)
            # a rank builds its block of the grid and builds or reads its
            # block of the initial state alone
            part, topology = None, None
            if self.partition is not None:
                part = self.partition.part(self.rank)
                topology = RankTopology(self.partition, self.rank, self.comm)
            gc = config.grid_config
            grid_data = generate_grid_data(
                config.nx_tile, config.nz, device=self.device, dtype=dtype,
                stretch_factor=gc.stretch_factor, lon_target=gc.lon_target,
                lat_target=gc.lat_target, eta_file=gc.eta_file,
                part=part,
            )
            dycore_state = config.initialization.get_dycore_state(
                sizing, self.device, dtype, part)
            self.state = DriverState(
                dycore_state=dycore_state, grid_data=grid_data,
                sizing=sizing, time=self.time,
            )
            # performance_config.sections: the phases of each step are
            # timed (the timer synchronises the device at each phase's
            # ends); without it the step holds no synchronisation at all
            self._section_timer = (
                self.performance_collector.timestep_timer
                if perf.sections else None)
            self.dycore = DynamicalCore(
                config.dycore_config, sizing, grid_data, config.dt_atmos,
                timer=self._section_timer, topology=topology)
            if not (config.dycore_only or config.disable_step_physics):
                # a Python float, read once: the step never asks the device
                self._ptop = float(grid_data.vertical.ptop)
                self.physics = Physics(
                    config.physics_config, grid_data.horizontal.area,
                    self._ptop, config.dt_atmos, device=self.device,
                )
                self.dycore_to_physics = DycoreToPhysics(
                    sizing, dtype=dtype, device=self.device,
                    domain=self.dycore.domain)
                self.end_of_step_update = UpdateAtmosphereState(
                    grid_data, self.dycore.topo, sizing, config.dt_atmos,
                    c2l_order=config.dycore_config.c2l_ord,
                    device=self.device,
                )
            else:
                self.physics = None
            self._step = self._build_step()
            self.diagnostics = (
                config.diagnostics_config.diagnostics_factory(
                    sizing, self.ranks)
            )
            self.safety_checker = SafetyChecker(sizing, self.comm,
                                                self.dycore.domain)
            if config.safety_check_frequency:
                register_default_checks()

    @classmethod
    def from_dict(cls, kwargs: dict, device="cuda") -> "Driver":
        return cls(DriverConfig.from_dict(kwargs), device=device)

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_step(self):
        dycore = self.dycore
        physics = self.physics
        cfg = self.config.dycore_config
        do_sg = cfg.fv_sg_adj > 0 and physics is not None
        timer = self._section_timer

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
                with (timer.clock("Physics") if timer is not None
                      else contextlib.nullcontext()):
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
        """The configured run: each step timed to one synchronisation of
        the device, then diagnostics, safety checks and intermediate
        restarts at their own cadence."""
        config = self.config
        collector = self.performance_collector
        if config.diagnostics_config.output_initial_state:
            self.diagnostics.store(self.time, self.state.dycore_state)
        n_steps = config.n_timesteps()
        self.profiler.enable()
        with collector.total_timer.clock("total"):
            for step in range(n_steps):
                collector.start_step()
                self.step()
                self._synchronize()
                collector.end_step()
                if (step + 1) % config.diagnostics_config.output_frequency \
                        == 0:
                    self.diagnostics.store(
                        self.time, self.state.dycore_state
                    )
                if config.safety_check_frequency and \
                        (step + 1) % config.safety_check_frequency == 0:
                    self.safety_checker.check_state(
                        self.state.dycore_state
                    )
                config.restart_config.write_intermediate_if_enabled(
                    self.state, step + 1, self.time, ranks=self.ranks
                )
        self.profiler.dump_stats()

    def cleanup(self):
        """Flush the perf JSON, the grid diagnostics, the diagnostics and
        the final restart.

        Called from run.py's try/finally, so it must survive a crashed
        step: the state is that of the last completed step, and each flush
        is independent, so a failure in one is logged and does not mask
        the original exception or block the others.  Over ranks each timer
        of the report is the maximum over the ranks, and rank 0 writes the
        files."""
        collector = self.performance_collector
        if self.comm is not None:
            collector.take_max(self.comm.all_gather(collector.times()))
        report = {}
        if self.rank == 0:
            report = collector.write_out_performance(
                f"torch/{self.device.type}", self.config.dt_atmos)
        for what, flush in (
            ("grid diagnostics",
             lambda: self.diagnostics.store_grid(self.state.grid_data)),
            ("diagnostics", self.diagnostics.cleanup),
            ("final restart",
             lambda: self.config.restart_config.write_final_if_enabled(
                 self.state, self.time, ranks=self.ranks)),
        ):
            try:
                flush()
            except Exception:
                logger.exception("cleanup: could not flush %s", what)
        return report
