"""Named accumulating timers (analogue of ai2cm/pace util/pace/util/_timing.py:9).

With `sync=True` a timer synchronises its device at each start and stop,
so the accumulated times are wall-clock sections of the device's work;
on the CPU the synchronisation is a no-op.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


class Timer:
    def __init__(self, sync: bool = True, device="cuda"):
        self._clock_starts: Dict[str, float] = {}
        self._accumulated: Dict[str, float] = {}
        self._hits: Dict[str, int] = {}
        self._enabled = True
        self._sync = sync
        self.device = torch.device(device)

    def _device_sync(self):
        if self._sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, name: str):
        if not self._enabled:
            return
        if name in self._clock_starts:
            raise ValueError(f"timer {name!r} started twice without stop")
        self._device_sync()
        self._clock_starts[name] = time.perf_counter()

    def stop(self, name: str):
        if not self._enabled:
            return
        self._device_sync()
        elapsed = time.perf_counter() - self._clock_starts.pop(name)
        self._accumulated[name] = self._accumulated.get(name, 0.0) + elapsed
        self._hits[name] = self._hits.get(name, 0) + 1

    def clock(self, name: str):
        return _TimerContext(self, name)

    @property
    def times(self) -> Dict[str, float]:
        return dict(self._accumulated)

    @property
    def hits(self) -> Dict[str, int]:
        return dict(self._hits)

    def reset(self):
        if self._clock_starts:
            raise ValueError("cannot reset while timers are running")
        self._accumulated.clear()
        self._hits.clear()

    def enable(self):
        self._enabled = True

    def disable(self):
        if self._clock_starts:
            raise ValueError("cannot disable while timers are running")
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled


class NullTimer(Timer):
    """A Timer that does nothing and cannot be enabled."""

    def __init__(self):
        super().__init__(sync=False)
        self._enabled = False

    def enable(self):
        raise NotImplementedError("NullTimer cannot be enabled")


class _TimerContext:
    def __init__(self, timer: Timer, name: str):
        self._timer, self._name = timer, name

    def __enter__(self):
        self._timer.start(self._name)
        return self

    def __exit__(self, *exc):
        self._timer.stop(self._name)
