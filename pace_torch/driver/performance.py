"""Performance collection: per-step timings, SYPD, JSON reports.

Port of `pace_tpu.driver.performance` (reference ai2cm/pace
driver/pace/driver/performance/{config,collector,report}.py): a
PerformanceConfig builds a collector that times each step and writes a JSON
report with simulated-years-per-day (SYPD), and optionally a profiler that
writes a Chrome trace of the time loop.  A report of several ranks also
lists each rank's initialization seconds and host and card memory peaks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import time
from typing import List, Optional

import torch

from pace_torch.utils.timing import NullTimer, Timer


def host_peak_bytes() -> int:
    """This process's peak resident host memory in bytes (Linux reports
    it in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@dataclasses.dataclass
class PerformanceConfig:
    """performance_mode enables timing collection; profile_dir (if set)
    wraps the time loop in `torch.profiler` and exports a Chrome trace
    there (view it in chrome://tracing or Perfetto)."""

    performance_mode: bool = True
    experiment_name: str = "test"
    json_all_rank_threshold: int = 1
    profile_dir: Optional[str] = None
    # sections=True times the phases of each step, DynCore /
    # TracerAdvection / Remapping (accumulated over k_split) and Physics,
    # synchronising the device at each phase's ends: a measuring mode that
    # costs those synchronisations (reference collector.py:60-153)
    sections: bool = False

    def build(self, device="cuda"):
        if self.performance_mode:
            return PerformanceCollector(self.experiment_name, device)
        return NullPerformanceCollector()

    def build_profiler(self, device="cuda"):
        if self.profile_dir:
            return TorchProfiler(self.profile_dir, device)
        return NullProfiler()


class TorchProfiler:
    """`torch.profiler` over the time loop (host and, on the card, device
    activity); `dump_stats` writes `<profile_dir>/trace.json`."""

    def __init__(self, logdir: str, device="cuda"):
        self.logdir = logdir
        self.device = torch.device(device)
        self._profile = None

    @property
    def trace_path(self) -> str:
        return os.path.join(self.logdir, "trace.json")

    def enable(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profile = torch.profiler.profile(activities=activities)
        self._profile.__enter__()

    def dump_stats(self, *_args):
        if self._profile is None:
            return
        profile, self._profile = self._profile, None
        profile.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        profile.export_chrome_trace(self.trace_path)


class NullProfiler:
    def enable(self):
        pass

    def dump_stats(self, *_args):
        pass


def _rank_entry(rank: int, times: dict) -> dict:
    """A rank's line of the report's `ranks` from its `times()`."""
    return dict(rank=rank,
                initialization=times["total_times"].get("initialization"),
                host_peak_bytes=times["host_peak_bytes"],
                device_peak_bytes=times["device_peak_bytes"])


class PerformanceCollector:
    def __init__(self, experiment_name: str = "test", device="cuda"):
        self.experiment_name = experiment_name
        self.total_timer = Timer(device=device)
        self.timestep_timer = Timer(device=device)
        self.times_per_step: List[dict] = []
        self._t0: Optional[float] = None
        # the totals' maximum over ranks, and each rank's initialization
        # seconds and host peak, once take_max has run
        self._max_totals: Optional[dict] = None
        self._ranks: Optional[List[dict]] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self):
        dt = time.perf_counter() - self._t0
        self.times_per_step.append(
            dict(mainloop=dt, **self.timestep_timer.times)
        )
        self.timestep_timer.reset()

    def times(self) -> dict:
        """This rank's timers, per step and totals, and its host peak and
        card peak (None off the card)."""
        device = self.total_timer.device
        return dict(times_per_step=self.times_per_step,
                    total_times=self.total_timer.times,
                    host_peak_bytes=host_peak_bytes(),
                    device_peak_bytes=(
                        torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else None))

    def take_max(self, every_rank: list):
        """Replace the timers by their maximum over ranks (`times()` of
        every rank): the slowest rank sets each step's pace."""
        steps = [r["times_per_step"] for r in every_rank]
        self.times_per_step = [
            {k: max(s[i][k] for s in steps) for k in steps[0][i]}
            for i in range(min(len(s) for s in steps))]
        totals = [r["total_times"] for r in every_rank]
        self._max_totals = {k: max(t[k] for t in totals)
                            for k in totals[0]}
        self._ranks = [_rank_entry(rank, r)
                       for rank, r in enumerate(every_rank)]

    def sypd(self, dt_atmos: float) -> float:
        """Simulated years per wall-clock day, excluding the first step."""
        steps = self.times_per_step[1:] or self.times_per_step
        if not steps:
            return 0.0
        wall = sum(s["mainloop"] for s in steps)
        simulated = dt_atmos * len(steps)
        return (simulated / wall) * (86400.0 / (365.0 * 86400.0))

    def write_out_performance(self, backend: str, dt_atmos: float,
                              path: str = "."):
        report = dict(
            experiment_name=self.experiment_name,
            backend=backend,
            dt_atmos=dt_atmos,
            sypd=self.sypd(dt_atmos),
            times_per_step=self.times_per_step,
            total_times=self._max_totals or self.total_timer.times,
        )
        # each rank's start and peaks: of one rank, its own
        report["ranks"] = self._ranks or [_rank_entry(0, self.times())]
        fname = f"{path}/{self.experiment_name}_perf.json"
        with open(fname, "w") as f:
            json.dump(report, f, indent=2)
        return report


class NullPerformanceCollector(PerformanceCollector):
    def __init__(self):
        super().__init__("null")
        self.total_timer = NullTimer()
        self.timestep_timer = NullTimer()

    def start_step(self):
        pass

    def end_step(self):
        pass

    def take_max(self, every_rank: list):
        pass

    def write_out_performance(self, backend, dt_atmos, path="."):
        return {}
