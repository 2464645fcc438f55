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


# NetCDF3 classic-format tags and types (the file is the one
# `scipy.io.netcdf_file(..., "w", version=2)` writes, byte for byte)
_ABSENT = b"\x00" * 8
_NC_DIMENSION = b"\x00\x00\x00\n"
_NC_VARIABLE = b"\x00\x00\x00\x0b"
_NC_ATTRIBUTE = b"\x00\x00\x00\x0c"
_NC_CHAR = b"\x00\x00\x00\x02"
_NC_TYPES = {"b": b"\x00\x00\x00\x01", "h": b"\x00\x00\x00\x03",
             "i": b"\x00\x00\x00\x04", "f": b"\x00\x00\x00\x05",
             "d": b"\x00\x00\x00\x06"}
_FILL = {"b": b"\x81", "h": b"\x80\x01", "i": b"\x80\x00\x00\x01",
         "f": b"\x7c\xf0\x00\x00", "d": b"\x47\x9e" + b"\x00" * 6}


def _written_dtype(dtype) -> np.dtype:
    """The dtype `_as_writable` writes an array of `dtype` as."""
    dtype = np.dtype(dtype)
    if dtype not in _TYPECODES:
        return np.dtype(np.float64)
    return {np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(bool): np.dtype(np.int8)}.get(dtype, dtype)


def _int(value: int) -> bytes:
    return np.array(value, ">i4").tobytes()


def _name(s: str) -> bytes:
    data = s.encode("latin1")
    return _int(len(data)) + data + b"\x00" * (-len(data) % 4)


def _padded(data: bytes) -> bytes:
    return data + b"\x00" * (-len(data) % 4)


def _write_big_endian(f, arr: np.ndarray) -> None:
    """`arr`'s values in big-endian order, a tile (leading index) at a
    time."""
    big = arr.dtype.newbyteorder(">")
    for chunk in (arr if arr.ndim else [arr]):
        f.write(np.ascontiguousarray(chunk, dtype=big).tobytes())


def write_dataset(
    filename: str,
    variables,
    dims: Optional[Dict[str, Sequence[str]]] = None,
    attrs: Optional[Dict[str, str]] = None,
    layout: Optional[Dict[str, Tuple[tuple, np.dtype]]] = None,
) -> None:
    """Write arrays to a NetCDF3 (64-bit offset) file: the header first,
    from every variable's shape and dtype, then each variable in turn at
    its place, so that only the variable being written is held.

    Args:
        variables: name -> array; or, with `layout`, an iterable of (name,
            array) pairs in any order, consumed one at a time.
        dims: optional name -> dimension-name tuple; same-named dimensions
            are shared (and must agree in size).  Defaults to per-variable
            (tile, x_<name>, y_<name>, ...) so no accidental coupling.
        attrs: global attributes (stored as strings).
        layout: name -> (shape, dtype) of every variable, in the order
            `variables` as a dict would give them.
    """
    dims = dims or {}
    if layout is None:
        layout = {name: (np.shape(a), np.asarray(a).dtype)
                  for name, a in variables.items()}
        variables = variables.items()
    dim_sizes: Dict[str, int] = {}
    planned = {}
    for name, (shape, dtype) in layout.items():
        shape = tuple(int(v) for v in shape)
        var_dims = tuple(dims.get(name)
                         or _default_dims(name, np.empty((0,) * len(shape))))
        if len(var_dims) != len(shape):
            raise ValueError(
                f"{name}: {len(var_dims)} dims for rank-{len(shape)} array"
            )
        for d, size in zip(var_dims, shape):
            if d in dim_sizes and dim_sizes[d] != size:
                raise ValueError(
                    f"dimension {d!r}: conflicting sizes "
                    f"{dim_sizes[d]} vs {size} (variable {name})"
                )
            if size == 0:
                raise ValueError(f"dimension {d!r} of {name} is empty")
            dim_sizes.setdefault(d, size)
        planned[name] = (shape, _written_dtype(dtype), var_dims)
    dim_ids = {d: k for k, d in enumerate(dim_sizes)}

    header = bytearray(b"CDF\x02" + _int(0))
    header += _NC_DIMENSION + _int(len(dim_sizes)) if dim_sizes else _ABSENT
    for d, size in dim_sizes.items():
        header += _name(d) + _int(size)
    if attrs:
        header += _NC_ATTRIBUTE + _int(len(attrs))
        for key, value in attrs.items():
            data = np.asarray(str(value), dtype="S")
            header += (_name(key) + _NC_CHAR + _int(data.itemsize)
                       + _padded(data.tobytes()))
    else:
        header += _ABSENT
    # the data lie in order of decreasing shape (equal shapes in the given
    # order), each padded to four bytes
    order = sorted(planned, key=lambda n: planned[n][0], reverse=True)
    header += _NC_VARIABLE + _int(len(order)) if order else _ABSENT
    begins, sizes = {}, {}
    for name in order:
        shape, dtype, var_dims = planned[name]
        vsize = int(np.prod(shape)) * dtype.itemsize
        sizes[name] = vsize
        vsize += -vsize % 4
        header += (_name(name) + _int(len(var_dims))
                   + b"".join(_int(dim_ids[d]) for d in var_dims) + _ABSENT
                   + _NC_TYPES[_TYPECODES[dtype]] + _int(vsize))
        begins[name] = len(header)
        header += bytes(8)
    offset = len(header)
    for name in order:
        header[begins[name]:begins[name] + 8] = np.array(
            offset, ">i8").tobytes()
        begins[name] = offset
        offset += sizes[name] + -sizes[name] % 4
    with open(filename, "wb") as f:
        f.write(header)
        written = set()
        for name, arr in variables:
            arr, code = _as_writable(arr)
            shape, dtype, _ = planned[name]
            if arr.shape != shape or arr.dtype != dtype or name in written:
                raise ValueError(f"{name}: {arr.dtype}{arr.shape} is not "
                                 f"the layout's {dtype}{shape} or came twice")
            f.seek(begins[name])
            _write_big_endian(f, arr)
            pad = -sizes[name] % 4
            f.write(_FILL[code] * (pad // len(_FILL[code])))
            written.add(name)
            del arr
        if written != set(planned):
            raise ValueError(f"variables {sorted(set(planned) - written)} "
                             "were not given")
        f.seek(offset)
        f.truncate()


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
