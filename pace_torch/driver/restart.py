"""Restart save/load.

Port of `pace_tpu.driver.restart` (reference RestartConfig / Restart,
driver/pace/driver/driver.py:198-240, and util restart IO).  `format: npz`
writes one standard `.npy` file per field under `dycore_state/` through
the native writer (`_native/fastpack`, built with g++ at first use; where
it cannot be built the write raises), the layout the reference package's
writer produces; `format: netcdf` writes `dycore_state.nc`.
`load_restart_arrays` reads either, and the single `dycore_state.npz` the
reference package falls back to.  In a multi-rank run rank 0 writes the
whole cube's restart from every rank's blocks, one field at a time
(`utils/host.fields_on_root`); each rank reads its own block back
(`RestartInit`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zipfile
from typing import Optional

import numpy as np

from pace_torch.utils.host import (
    drain,
    fields_on_root,
    root_layout,
    to_host,
)


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
    the whole cube's, one field at a time."""
    arrays = to_host({
        f.name: getattr(dycore_state, f.name)
        for f in dataclasses.fields(dycore_state)
    })
    fields = fields_on_root(arrays, ranks)
    if ranks is not None and ranks[1].rank != 0:
        drain(fields)
        return
    os.makedirs(path, exist_ok=True)
    if format == "netcdf":
        from pace_torch.utils.netcdf import write_dataset

        write_dataset(
            os.path.join(path, "dycore_state.nc"), fields,
            attrs={"time": str(time) if time else ""},
            layout=root_layout(arrays, ranks),
        )
    else:
        from pace_torch._native.fastpack import write_npy

        directory = os.path.join(path, "dycore_state")
        os.makedirs(directory, exist_ok=True)
        for name, array in fields:
            write_npy(os.path.join(directory, name + ".npy"), array)
            del array
    with open(os.path.join(path, "time.json"), "w") as f:
        json.dump({"time": str(time) if time else None}, f)


def load_restart_arrays(path: str, part=None) -> dict:
    """The restart's fields, whole or the block `part`
    (`Partition.part(rank)`) holds: a rank reads one field at a time and
    keeps only its block of it (the .npy files and the NetCDF file through
    memory maps)."""
    nc_path = os.path.join(path, "dycore_state.nc")
    if os.path.exists(nc_path):
        from pace_torch.utils.netcdf import read_dataset

        return read_dataset(nc_path, None if part is None else part.cut)
    npy_dir = os.path.join(path, "dycore_state")
    if os.path.isdir(npy_dir):
        from pace_torch._native.fastpack import read_npy

        names = sorted(f for f in os.listdir(npy_dir) if f.endswith(".npy"))
        if part is None:
            return {f[:-4]: read_npy(os.path.join(npy_dir, f))
                    for f in names}
        return {f[:-4]: np.array(part.cut(np.load(
            os.path.join(npy_dir, f), mmap_mode="r"))) for f in names}
    return dict(_npz_blocks(os.path.join(path, "dycore_state.npz"),
                            (lambda a: a) if part is None else part.cut))


def _npz_blocks(path: str, cut):
    """(name, cut of the field) for each array of an .npz, one at a time:
    a member stored uncompressed (`numpy.savez`) read through a memory map
    of its bytes, a compressed one read whole."""
    with zipfile.ZipFile(path) as archive, open(path, "rb") as f:
        for info in archive.infolist():
            name = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED:
                with archive.open(info) as member:
                    yield name, np.array(cut(np.lib.format.read_array(
                        member)))
                continue
            # the member's local header: its name and extra field lengths
            # at bytes 26-29, then the .npy file itself
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(f))
            data = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                             shape=shape, order="F" if fortran else "C")
            yield name, np.array(cut(data))
            del data
