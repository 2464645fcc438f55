"""Diagnostics output.

Port of `pace_tpu.driver.diagnostics` (reference ai2cm/pace
driver/pace/driver/diagnostics.py DiagnosticsConfig, Diagnostics,
ZSelect): saves selected state variables at a configurable frequency, as
npz (one file per output time), NetCDF3 time-series chunks or a Zarr v2
store.  The files are those of the reference package.  The selected fields
are cut to the compute domain and the column integrals taken on the
device; each output then reads the device once (`utils/host.to_host`).
In a multi-rank run every rank sends its blocks to rank 0, which writes
the whole cube's one field at a time (`utils/host.fields_on_root`): the
files of a one-rank run.  The NetCDF time series alone keeps whole
records, `time_chunk_size` of them, as the reference's monitor does.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import zipfile
from typing import Iterable, List, Optional

import numpy as np

from pace_torch.models.fv3.state import FIELD_METADATA
from pace_torch.utils.constants import GRAV
from pace_torch.utils.host import (
    drain,
    fields_on_root,
    root_layout,
    to_host,
)

GRID_NAMES = ("lon", "lat", "lon_agrid", "lat_agrid", "area")


@dataclasses.dataclass
class ZSelect:
    level: int
    names: List[str]


@dataclasses.dataclass
class DiagnosticsConfig:
    """
    Attributes:
        path: directory to save diagnostics into; no diagnostics are stored
            if unset
        output_format: "npz", "netcdf" (NetCDF3 64-bit-offset via scipy,
            chunked time-series files as in the reference NetCDFMonitor) or
            "zarr" (utils/zarrlite.py)
        names: state variables to save
        derived_names: derived diagnostics to save; supported:
            column_integrated_<tracer> (kg/m**2, reference
            driver/pace/driver/diagnostics.py:227-252)
        z_select: save a vertical slice of a 3D state
        output_initial_state: save the state before the first step
        output_frequency: timesteps between outputs
    """

    path: Optional[str] = None
    output_format: str = "npz"
    names: List[str] = dataclasses.field(default_factory=list)
    derived_names: List[str] = dataclasses.field(default_factory=list)
    z_select: List[ZSelect] = dataclasses.field(default_factory=list)
    output_initial_state: bool = False
    output_frequency: int = 1

    def __post_init__(self):
        if (self.names or self.derived_names) and self.path is None:
            raise ValueError(
                "DiagnosticsConfig.path must be given to enable diagnostics"
            )
        if self.output_format not in ("npz", "netcdf", "zarr"):
            raise ValueError(
                "output_format must be 'npz', 'netcdf' or 'zarr', "
                f"got {self.output_format}"
            )
        for name in self.derived_names:
            if not name.startswith("column_integrated_"):
                raise ValueError(
                    f"unsupported derived diagnostic {name!r}; supported: "
                    "column_integrated_<tracer>"
                )
            # fail at config time, not hours into the run at the first
            # output boundary
            tracer = name[len("column_integrated_"):]
            if tracer not in FIELD_METADATA:
                raise ValueError(
                    f"derived diagnostic {name!r} references unknown "
                    f"tracer {tracer!r} (not a DycoreState field)"
                )

    def diagnostics_factory(self, sizing=None, ranks=None) -> "Diagnostics":
        """`ranks`: (Partition, Comm) of a multi-rank run."""
        if self.path is None:
            return NullDiagnostics()
        if self.output_format == "netcdf":
            return NetCDFDiagnostics(self, sizing, ranks)
        if self.output_format == "zarr":
            return ZarrDiagnostics(self, sizing, ranks)
        return NpzDiagnostics(self, sizing, ranks)


class Diagnostics:
    def store(self, time, state):
        raise NotImplementedError

    def store_grid(self, grid_data):
        raise NotImplementedError

    def cleanup(self):
        pass


class NullDiagnostics(Diagnostics):
    def store(self, time, state):
        pass

    def store_grid(self, grid_data):
        pass


def _grid_arrays(grid_data) -> dict:
    hz = grid_data.horizontal
    return to_host({name: getattr(hz, name) for name in GRID_NAMES})


def write_npz(path: str, fields: Iterable) -> None:
    """An uncompressed .npz of the (name, array) pairs `fields`, written
    one member at a time as `numpy.savez` writes them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as archive:
        for name, value in fields:
            with archive.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value))
            del value


class NpzDiagnostics(Diagnostics):
    def __init__(self, config: DiagnosticsConfig, sizing=None, ranks=None):
        self.config = config
        self.sizing = sizing
        self.ranks = ranks
        self.root = ranks is None or ranks[1].rank == 0
        if self.root:
            os.makedirs(config.path, exist_ok=True)
        self._index = 0

    def _compute_domain(self, arr, name=None):
        """Slice off the halo+padding: users get exactly the compute
        domain — n cells, or n+1 points on a staggered (interface) axis,
        determined from the state's dims metadata."""
        if self.sizing is None or arr.ndim < 3:
            return arr
        h, n = self.sizing.halo, self.sizing.n
        ni = nj = n
        if name in FIELD_METADATA:
            dims = FIELD_METADATA[name][1]
            if "x_interface" in dims[0]:
                ni = n + 1
            if "y_interface" in dims[1]:
                nj = n + 1
        return arr[:, h:h + ni, h:h + nj]

    def _fields(self, state):
        """The configured (and derived) variables as (name, halo-stripped
        numpy array) pairs, read from the device in one transfer: the
        whole cube's, one at a time, on rank 0 (each rank sends its block,
        and rank 0 strips each gathered field); nothing on the other ranks,
        which run the generator to its end.  Returns (names, generator)."""
        fields = {}  # output name: (array, name of its metadata)
        for name in self.config.names:
            fields[name] = (getattr(state, name), name)
        for name in self.config.derived_names:
            tracer = name[len("column_integrated_"):]
            fields[name] = (
                _column_integral(getattr(state, tracer), state.delp), tracer)
        for zs in self.config.z_select:
            for name in zs.names:
                fields[f"{name}_z{zs.level}"] = (
                    getattr(state, name)[..., zs.level], name)
        arrays = to_host({key: a for key, (a, _) in fields.items()})

        def stripped():
            for key, a in fields_on_root(arrays, self.ranks):
                yield key, self._compute_domain(a, fields[key][1])
                del a  # before the next field is assembled

        return list(fields), stripped()

    def _grid(self, grid_data):
        """(layout, generator) of the grid's fields, as `_fields`."""
        arrays = _grid_arrays(grid_data)
        return (root_layout(arrays, self.ranks),
                fields_on_root(arrays, self.ranks))

    def store(self, time, state):
        _, fields = self._fields(state)
        if not self.root:
            return drain(fields)
        if time is not None:
            fields = itertools.chain(fields,
                                     [("time", np.asarray(str(time)))])
        write_npz(os.path.join(self.config.path,
                               f"state_{self._index:06d}.npz"), fields)
        self._index += 1

    def store_grid(self, grid_data):
        _, fields = self._grid(grid_data)
        if not self.root:
            return drain(fields)
        write_npz(os.path.join(self.config.path, "grid.npz"), fields)


def _column_integral(q, delp):
    """Column-integrated tracer path in kg/m**2: sum_k q*delp / g
    (reference driver/pace/driver/diagnostics.py:227-252)."""
    return (q * delp).sum(-1) / GRAV


class NetCDFDiagnostics(NpzDiagnostics):
    """Diagnostics through the chunked NetCDF3 time-series monitor
    (reference monitor/netcdf_monitor.py:104); shares variable collection
    (incl. derived and z-select) with the npz path.  The monitor buffers
    whole records, as the reference's does."""

    def __init__(self, config: DiagnosticsConfig, sizing=None, ranks=None):
        from pace_torch.utils.netcdf import NetCDFMonitor

        super().__init__(config, sizing, ranks)
        self._monitor = NetCDFMonitor(config.path) if self.root else None

    def store(self, time, state):
        _, fields = self._fields(state)
        if not self.root:
            return drain(fields)
        out = dict(fields)
        out["time"] = time
        self._monitor.store(out)

    def store_grid(self, grid_data):
        from pace_torch.utils.netcdf import write_dataset

        layout, fields = self._grid(grid_data)
        if not self.root:
            return drain(fields)
        write_dataset(os.path.join(self.config.path, "grid.nc"), fields,
                      layout=layout)

    def cleanup(self):
        if self._monitor is not None:
            self._monitor.cleanup()


class ZarrDiagnostics(NpzDiagnostics):
    """Diagnostics into a Zarr v2 store (dependency-free writer,
    utils/zarrlite.py; reference monitor/zarr_monitor.py:37 layout:
    one (time, tile, x, y[, z]) array per variable), one field at a
    time."""

    def __init__(self, config: DiagnosticsConfig, sizing=None, ranks=None):
        from pace_torch.utils.zarrlite import ZarrMonitor

        super().__init__(config, sizing, ranks)
        self._monitor = (ZarrMonitor(os.path.join(config.path, "state.zarr"))
                         if self.root else None)

    def store(self, time, state):
        names, fields = self._fields(state)
        if not self.root:
            return drain(fields)
        self._monitor.store_fields(names, fields, time)

    def store_grid(self, grid_data):
        from pace_torch.utils.zarrlite import ZarrMonitor

        layout, fields = self._grid(grid_data)
        if not self.root:
            return drain(fields)
        ZarrMonitor(os.path.join(self.config.path, "grid.zarr")).store_fields(
            list(layout), fields, 0)
