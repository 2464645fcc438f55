"""NetCDF3 dataset write/read on scipy — the interop format.

The port's own copy of `pace_tpu.utils.netcdf`, so that files written by
either package read back equal in the other; tensors on any device are
accepted wherever arrays are.  Analogue of the reference's
xarray/netCDF4-based state I/O and time-series monitor (ai2cm/pace
util/pace/util/io.py:11-60 write_state / read_state,
util/pace/util/monitor/netcdf_monitor.py:104 NetCDFMonitor with its chunked
writer :43), on NetCDF3 64-bit-offset files through
``scipy.io.netcdf_file`` (the format the Fortran FMS restarts use).

Layout: global cube arrays (tile, x, y[, z]) written with dims ("tile",
"x", "y", "z") — plus a leading record "time" dimension in the monitor
files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pace_torch.utils.host import as_numpy

# NetCDF3 has no 64-bit integer type; integers are stored as int32.
_TYPECODES = {
    np.dtype(np.float64): "d",
    np.dtype(np.float32): "f",
    np.dtype(np.int32): "i",
    np.dtype(np.int64): "i",
    np.dtype(np.int16): "h",
    np.dtype(np.int8): "b",
    np.dtype(bool): "b",
}


def _as_writable(arr: np.ndarray) -> Tuple[np.ndarray, str]:
    arr = np.asarray(arr)
    if arr.dtype not in _TYPECODES:
        arr = arr.astype(np.float64)
    code = _TYPECODES[arr.dtype]
    if arr.dtype == np.dtype(np.int64):
        # NetCDF3 has no 64-bit integer type; narrowing must be lossless
        info = np.iinfo(np.int32)
        if arr.size and (arr.max() > info.max or arr.min() < info.min):
            raise OverflowError(
                "int64 value out of int32 range cannot be stored in a "
                "NetCDF3 file"
            )
        arr = arr.astype(np.int32)
    elif arr.dtype == np.dtype(bool):
        arr = arr.astype(np.int8)
    return arr, code


def _default_dims(name: str, arr: np.ndarray) -> Tuple[str, ...]:
    """Dimension names for an array: cube arrays (rank>=3) get a shared
    "tile" axis plus per-variable x/y/z names (staggered fields differ in
    size); lower-rank arrays get fully per-variable names."""
    if arr.ndim >= 3:
        base = ("tile", f"x_{name}", f"y_{name}", f"z_{name}")
        if arr.ndim <= 4:
            return base[: arr.ndim]
        return base + tuple(f"d{k}_{name}" for k in range(arr.ndim - 4))
    return tuple(f"d{k}_{name}" for k in range(arr.ndim))


def write_dataset(
    filename: str,
    variables: Dict[str, np.ndarray],
    dims: Optional[Dict[str, Sequence[str]]] = None,
    attrs: Optional[Dict[str, str]] = None,
) -> None:
    """Write arrays to a NetCDF3 (64-bit offset) file.

    Args:
        variables: name -> array.
        dims: optional name -> dimension-name tuple; same-named dimensions
            are shared (and must agree in size).  Defaults to per-variable
            (tile, x_<name>, y_<name>, ...) so no accidental coupling.
        attrs: global attributes (stored as strings).
    """
    from scipy.io import netcdf_file

    dims = dims or {}
    f = netcdf_file(filename, "w", version=2)
    try:
        for key, value in (attrs or {}).items():
            setattr(f, key, str(value))
        dim_sizes: Dict[str, int] = {}
        planned = {}
        for name, arr in variables.items():
            arr, code = _as_writable(arr)
            var_dims = tuple(dims.get(name) or _default_dims(name, arr))
            if len(var_dims) != arr.ndim:
                raise ValueError(
                    f"{name}: {len(var_dims)} dims for rank-{arr.ndim} array"
                )
            for d, size in zip(var_dims, arr.shape):
                if d in dim_sizes:
                    if dim_sizes[d] != size:
                        raise ValueError(
                            f"dimension {d!r}: conflicting sizes "
                            f"{dim_sizes[d]} vs {size} (variable {name})"
                        )
                else:
                    dim_sizes[d] = size
                    f.createDimension(d, size)
            planned[name] = (arr, code, var_dims)
        for name, (arr, code, var_dims) in planned.items():
            v = f.createVariable(name, code, var_dims)
            v[:] = arr
    finally:
        f.close()


def read_dataset(filename: str, cut=None) -> Dict[str, np.ndarray]:
    """Read all variables from a NetCDF file into plain numpy arrays, read
    one at a time from a memory map of the file; with `cut` (a function of
    an array, such as `RankPart.cut`) each is cut as it is read, so that
    no whole variable is held."""
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(filename, "r", mmap=True) as f:
        for name in list(f.variables):
            data = f.variables[name].data
            data = data if cut is None else cut(data)
            # NetCDF stores big-endian: a copy in native byte order, so that
            # nothing refers to the map once the file is closed
            out[name] = np.array(data, order="C",
                                 dtype=data.dtype.newbyteorder("="))
            del data
    return out


def read_dataset_with_dims(
    filename: str,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Tuple[str, ...]]]:
    """Like read_dataset, but also return each variable's dimension-name
    tuple (needed by the savepoint/translate harness to locate the
    ``rank`` and ``savepoint`` axes)."""
    from scipy.io import netcdf_file

    f = netcdf_file(filename, "r", mmap=False)
    try:
        arrays, dims = {}, {}
        for name, var in f.variables.items():
            arrays[name] = np.ascontiguousarray(var[:]).astype(
                np.dtype(var[:].dtype).newbyteorder("="), copy=False
            )
            dims[name] = tuple(var.dimensions)
        return arrays, dims
    finally:
        f.close()


def read_attrs(filename: str) -> Dict[str, str]:
    from scipy.io import netcdf_file

    f = netcdf_file(filename, "r", mmap=False)
    try:
        out = {}
        for key, value in f._attributes.items():
            out[key] = (
                value.decode() if isinstance(value, bytes) else str(value)
            )
        return out
    finally:
        f.close()


def write_state(state: Dict, filename: str) -> None:
    """NetCDF analogue of utils.monitor.write_state (reference io.py:11):
    state is a dict of cube arrays plus a 'time' entry, stored as a global
    attribute."""
    if "time" not in state:
        raise ValueError('state must include a value for "time"')
    arrays = {
        name: as_numpy(value)
        for name, value in state.items()
        if name != "time"
    }
    write_dataset(filename, arrays, attrs={"time": str(state["time"])})


def read_state(filename: str) -> Dict:
    """Read a state written by write_state (reference io.py:40)."""
    state = dict(read_dataset(filename))
    time = read_attrs(filename).get("time")
    if time is not None:
        state["time"] = time
    return state


class NetCDFMonitor:
    """Time-appending series writer: accumulates states and flushes them
    as chunked NetCDF files ``state_<first_index>.nc`` with a leading
    "time" dimension, mirroring the reference's chunked NetCDF monitor
    (netcdf_monitor.py:43 _ChunkedNetCDFWriter; chunk boundary behavior
    :104).  Call ``cleanup()`` (or rely on ``store`` at chunk boundaries)
    to flush."""

    def __init__(self, path: str, time_chunk_size: int = 8):
        self.path = path
        self.time_chunk_size = time_chunk_size
        os.makedirs(path, exist_ok=True)
        self._pending = []  # list of (time, {name: array})
        self._flushed = 0

    def store(self, state: Dict) -> None:
        time = state.get("time")
        arrays = {
            name: as_numpy(value)
            for name, value in state.items()
            if name != "time"
        }
        self._pending.append((time, arrays))
        if len(self._pending) >= self.time_chunk_size:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        first = self._flushed
        times = [t for t, _ in self._pending]
        names = self._pending[0][1].keys()
        stacked = {
            name: np.stack([arrays[name] for _, arrays in self._pending])
            for name in names
        }
        dims = {
            name: ("time",) + _default_dims(name, arr[0])
            for name, arr in stacked.items()
        }
        write_dataset(
            os.path.join(self.path, f"state_{first:06d}.nc"),
            stacked,
            dims=dims,
            attrs={"times": ";".join(str(t) for t in times)},
        )
        self._flushed += len(self._pending)
        self._pending = []

    def cleanup(self) -> None:
        self._flush()

    @classmethod
    def read(cls, path: str):
        """Returns (times, list of {name: array} per time) across chunks."""
        times, states = [], []
        for fname in sorted(os.listdir(path)):
            if not (fname.startswith("state_") and fname.endswith(".nc")):
                continue
            full = os.path.join(path, fname)
            data = read_dataset(full)
            chunk_times = read_attrs(full).get("times", "")
            chunk_times = chunk_times.split(";") if chunk_times else []
            n = len(chunk_times)
            for i in range(n):
                times.append(chunk_times[i])
                states.append({k: v[i] for k, v in data.items()})
        return times, states
