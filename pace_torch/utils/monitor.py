"""Time-appending model output monitors and state I/O.

Port of `pace_tpu.utils.monitor` (ai2cm/pace util/pace/util/monitor/ and
util/pace/util/io.py write_state / read_state): npz files, one per store
call, with an index json for the series, in the reference package's layout
so that either package reads what the other wrote.  A store copies device
tensors to the host once (`utils.host.to_host`).  The NetCDF monitor and
state files are re-exported from `utils.netcdf`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pace_torch.utils.host import to_host
from pace_torch.utils.netcdf import (  # noqa: F401  (re-export)
    NetCDFMonitor,
    read_state as read_state_netcdf,
    write_state as write_state_netcdf,
)


class Monitor:
    def store(self, state: dict) -> None:
        raise NotImplementedError

    def cleanup(self):
        pass


class DummyMonitor(Monitor):
    def store(self, state: dict) -> None:
        pass


class NpzMonitor(Monitor):
    """Appends states to a time series directory: step_<i>.npz per store
    call plus index.json with the times and file names."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._times = []
        self._files = []

    def store(self, state: dict) -> None:
        fname = f"step_{len(self._files):06d}.npz"
        time = state.get("time")
        arrays = to_host({k: v for k, v in state.items() if k != "time"})
        np.savez(os.path.join(self.path, fname), **arrays)
        self._times.append(str(time) if time is not None else None)
        self._files.append(fname)
        with open(os.path.join(self.path, "index.json"), "w") as f:
            json.dump({"times": self._times, "files": self._files}, f)

    @classmethod
    def read(cls, path: str):
        """Returns (times, list of {name: array} dicts)."""
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        states = []
        for fname in index["files"]:
            with np.load(os.path.join(path, fname)) as data:
                states.append({k: data[k] for k in data.files})
        return index["times"], states


def write_state(state: dict, filename: str) -> None:
    """Write a model state dict (must include 'time') to one npz file
    (reference io.py:11-38)."""
    if "time" not in state:
        raise ValueError('state must include a value for "time"')
    arrays = to_host({k: v for k, v in state.items() if k != "time"})
    arrays["__time__"] = np.asarray(str(state["time"]))
    np.savez(filename, **arrays)


def read_state(filename: str) -> dict:
    """Read a model state written by write_state (reference io.py:40-60)."""
    state = {}
    with np.load(filename) as data:
        for name in data.files:
            if name == "__time__":
                state["time"] = str(data[name])
            else:
                state[name] = data[name]
    return state
