"""Dependency-free Zarr v2 store writer/reader — time-series monitor.

The port's own copy of `pace_tpu.utils.zarrlite`: stores written by either
package read back equal in the other.

No `zarr` package is needed: the Zarr v2 on-disk format is just
directories of JSON metadata (`.zgroup`, `.zarray`, `.zattrs`) plus raw
chunk files, so a small writer gives full interop with the zarr/xarray
ecosystem the reference targets (ai2cm/pace
util/pace/util/monitor/zarr_monitor.py:37 ZarrMonitor — one array per
variable laid out (time, tile, y, x[, z]), appended along time).

Chunks are written uncompressed (compressor: null), one chunk per
(time, tile) like the reference's per-rank chunking; any zarr v2 client
(zarr-python, xarray.open_zarr, tensorstore) reads these stores.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np

from pace_torch.utils.host import as_numpy

_DTYPE_MAP = {
    np.dtype(np.float64): "<f8",
    np.dtype(np.float32): "<f4",
    np.dtype(np.int64): "<i8",
    np.dtype(np.int32): "<i4",
    np.dtype(np.int8): "|i1",
    np.dtype(bool): "|b1",
}


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


class ZarrVariableWriter:
    """One growing zarr v2 array, appended one (time, tile, ...) chunk at
    a time (analogue of reference _ZarrVariableWriter)."""

    def __init__(self, group_dir: str, name: str):
        self.dir = os.path.join(group_dir, name)
        self.name = name
        self.n_times = 0
        self._field_shape = None
        self._dtype = None

    def _init(self, sample: np.ndarray, attrs: Dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        self._field_shape = sample.shape  # (tile, y, x, ...) global
        self._dtype = sample.dtype
        self._attrs = attrs
        self._write_meta()

    def _write_meta(self) -> None:
        dt = _DTYPE_MAP.get(np.dtype(self._dtype))
        if dt is None:
            raise TypeError(f"unsupported dtype {self._dtype}")
        _write_json(os.path.join(self.dir, ".zarray"), {
            "zarr_format": 2,
            "shape": [self.n_times] + list(self._field_shape),
            "chunks": [1, 1] + list(self._field_shape[1:]),
            "dtype": dt,
            "compressor": None,
            "fill_value": None,
            "filters": None,
            "order": "C",
        })
        _write_json(os.path.join(self.dir, ".zattrs"), self._attrs)

    def append(self, value: np.ndarray, attrs: Optional[Dict] = None):
        """Write `value` as the next time's chunks, one tile's copy at a
        time (a view of a larger array is not copied whole)."""
        value = np.asarray(value)
        if self._field_shape is None:
            self._init(value, attrs or {})
        if value.shape != self._field_shape:
            raise ValueError(
                f"{self.name}: shape {value.shape} != {self._field_shape}")
        t = self.n_times
        dtype = np.dtype(_DTYPE_MAP[np.dtype(self._dtype)])
        for tile in range(value.shape[0]):
            chunk_key = ".".join(
                [str(t), str(tile)] + ["0"] * (value.ndim - 1))
            with open(os.path.join(self.dir, chunk_key), "wb") as f:
                f.write(np.ascontiguousarray(value[tile], dtype=dtype).data)
        self.n_times += 1
        self._write_meta()


class ZarrMonitor:
    """Time-appending model-output writer in the reference's store layout
    (zarr_monitor.py:37): one array per variable, dims
    (time, tile, x, y[, z]); 'time' stored as ISO strings."""

    def __init__(self, store_path: str):
        self.path = store_path
        os.makedirs(store_path, exist_ok=True)
        _write_json(os.path.join(store_path, ".zgroup"), {"zarr_format": 2})
        self._writers: Dict[str, ZarrVariableWriter] = {}
        self._time_dir = os.path.join(store_path, "time")
        self._times = []

    def store(self, state: Dict) -> None:
        names = [k for k in state if k != "time"]
        self.store_fields(names, ((k, state[k]) for k in names),
                          state.get("time", len(self._times)))

    def store_fields(self, names, fields: Iterable, time) -> None:
        """One record of the variables `names`, taken from the (name,
        array) pairs `fields` one at a time (each written before the next
        is taken), at `time`."""
        # every store must carry the same variables, or per-variable
        # arrays silently desynchronize from the shared time axis (the
        # NetCDF monitor fails loudly on the same input — match it)
        names = set(names)
        if self._writers and names != set(self._writers):
            raise KeyError(
                "inconsistent variables between zarr store calls: "
                f"got {sorted(names)}, expected {sorted(self._writers)}"
            )
        for name, value in fields:
            arr = as_numpy(value)
            if name not in self._writers:
                self._writers[name] = ZarrVariableWriter(self.path, name)
                dims = ["time", "tile", "x", "y", "z"][: arr.ndim + 1]
                self._writers[name]._init(
                    arr, {"_ARRAY_DIMENSIONS": dims})
            self._writers[name].append(arr)
            del arr, value
        self._times.append(str(time))
        self._write_time()

    def _write_time(self) -> None:
        os.makedirs(self._time_dir, exist_ok=True)
        data = np.array(self._times, dtype="U64")
        n = len(self._times)
        _write_json(os.path.join(self._time_dir, ".zarray"), {
            "zarr_format": 2,
            "shape": [n],
            "chunks": [max(n, 1)],
            "dtype": "<U64",
            "compressor": None,
            "fill_value": None,
            "filters": None,
            "order": "C",
        })
        _write_json(os.path.join(self._time_dir, ".zattrs"),
                    {"_ARRAY_DIMENSIONS": ["time"]})
        with open(os.path.join(self._time_dir, "0"), "wb") as f:
            f.write(data.astype("<U64").tobytes())

    def cleanup(self) -> None:
        pass


def read_zarr_array(array_dir: str) -> np.ndarray:
    """Read a (possibly chunked) uncompressed zarr v2 array — the test
    half of the round trip; real consumers use zarr/xarray."""
    with open(os.path.join(array_dir, ".zarray")) as f:
        meta = json.load(f)
    if meta.get("compressor") is not None:
        raise NotImplementedError("compressed chunks")
    shape = meta["shape"]
    chunks = meta["chunks"]
    dtype = np.dtype(meta["dtype"])
    out = np.zeros(shape, dtype)
    grid = [
        -(-s // c) for s, c in zip(shape, chunks)
    ]
    idx = np.ndindex(*grid)
    for key in idx:
        fname = os.path.join(array_dir, ".".join(map(str, key)))
        if not os.path.exists(fname):
            continue
        chunk = np.frombuffer(open(fname, "rb").read(), dtype=dtype)
        cshape = [
            min(c, s - k * c) for k, s, c in zip(key, shape, chunks)
        ]
        full = chunk.reshape(chunks)
        sel = tuple(
            slice(k * c, k * c + cs)
            for k, c, cs in zip(key, chunks, cshape)
        )
        out[sel] = full[tuple(slice(0, cs) for cs in cshape)]
    return out
