"""Restart save/load.

Port of `pace_tpu.driver.restart` (reference RestartConfig / Restart,
driver/pace/driver/driver.py:198-240, and util restart IO).  `format: npz`
writes one standard `.npy` file per field under `dycore_state/` through
the threaded native writer (`_native/fastpack`, built with g++ at first
use; where it cannot be built the write raises), the layout the reference
package's writer produces; `format: netcdf` writes `dycore_state.nc`.
`load_restart_arrays` reads either, and the single `dycore_state.npz` the
reference package falls back to.  In a multi-rank run rank 0 writes the
whole cube's restart from every rank's tiles; each rank reads its own
tiles back (`RestartInit`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from pace_torch.utils.host import on_root, to_host


@dataclasses.dataclass
class RestartConfig:
    save_restart: bool = False
    intermediate_restart: list = dataclasses.field(default_factory=list)
    path: str = "RESTART"
    # "npz" (a directory of .npy files) or "netcdf" (NetCDF3 interop,
    # reference util/pace/util/io.py:11 write_state)
    format: str = "npz"

    def __post_init__(self):
        if self.format not in ("npz", "netcdf"):
            raise ValueError(
                f"restart format must be 'npz' or 'netcdf', got {self.format}"
            )

    def write_final_if_enabled(self, state, time, path: Optional[str] = None,
                               ranks=None):
        if self.save_restart:
            write_restart(
                state.dycore_state, time, path or self.path, self.format,
                ranks,
            )

    def write_intermediate_if_enabled(self, state, step: int, time,
                                      ranks=None):
        if step in self.intermediate_restart:
            write_restart(
                state.dycore_state, time,
                os.path.join(self.path, f"step_{step:06d}"), self.format,
                ranks,
            )


def write_restart(dycore_state, time, path: str, format: str = "npz",
                  ranks=None):
    """Write the restart of `dycore_state`; with `ranks` ((Partition,
    Comm) of a multi-rank run) every rank calls this and rank 0 writes
    the whole cube's."""
    arrays = on_root(to_host({
        f.name: getattr(dycore_state, f.name)
        for f in dataclasses.fields(dycore_state)
    }), ranks)
    if arrays is None:
        return
    os.makedirs(path, exist_ok=True)
    if format == "netcdf":
        from pace_torch.utils.netcdf import write_dataset

        write_dataset(
            os.path.join(path, "dycore_state.nc"), arrays,
            attrs={"time": str(time) if time else ""},
        )
    else:
        from pace_torch._native.fastpack import write_state_npys

        write_state_npys(os.path.join(path, "dycore_state"), arrays)
    with open(os.path.join(path, "time.json"), "w") as f:
        json.dump({"time": str(time) if time else None}, f)


def load_restart_arrays(path: str) -> dict:
    nc_path = os.path.join(path, "dycore_state.nc")
    if os.path.exists(nc_path):
        from pace_torch.utils.netcdf import read_dataset

        return read_dataset(nc_path)
    npy_dir = os.path.join(path, "dycore_state")
    if os.path.isdir(npy_dir):
        from pace_torch._native.fastpack import read_npy

        return {
            fname[:-4]: read_npy(os.path.join(npy_dir, fname))
            for fname in sorted(os.listdir(npy_dir))
            if fname.endswith(".npy")
        }
    data = np.load(os.path.join(path, "dycore_state.npz"))
    return {k: data[k] for k in data.files}
