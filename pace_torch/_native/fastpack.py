"""ctypes bindings of the threaded .npy writer and reader (fastpack.cpp).

The library is built at first use with
`g++ -O3 -shared -fPIC -std=c++17 -pthread` into build/pace_torch/ beside
the package (the directory of the CUDA kernel library), and rebuilt when
the source's hash changes.  Where g++ is missing or the build fails, the
first call raises: nothing falls back to numpy.  The files are standard
.npy (v1.0), readable by `numpy.load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "fastpack.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "pace_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

_LIB = None


def build() -> pathlib.Path:
    """Compile fastpack.cpp into build/pace_torch/libfastpack_<hash>.so
    unless it exists; returns its path.  Raises where g++ is missing or
    fails."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"libfastpack_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the fastpack writer cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.fastpack_write_npy.restype = ctypes.c_int
        lib.fastpack_write_npy.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ]
        lib.fastpack_write_many.restype = ctypes.c_int
        lib.fastpack_write_many.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        lib.fastpack_read_npy_info.restype = ctypes.c_longlong
        lib.fastpack_read_npy_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastpack_read_npy_data.restype = ctypes.c_longlong
        lib.fastpack_read_npy_data.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        _LIB = lib
    return _LIB


def _code(arr: np.ndarray) -> int:
    if arr.dtype not in _DTYPE_CODES:
        raise TypeError(f"fastpack writes float32/float64/int32/int64, "
                        f"not {arr.dtype}")
    return _DTYPE_CODES[arr.dtype]


def write_npy(path: str, array: np.ndarray) -> None:
    """Write one array as a .npy file."""
    lib = library()
    arr = np.require(array, requirements="C")
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    rc = lib.fastpack_write_npy(path.encode(), _code(arr), arr.ndim, shape,
                                arr.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"fastpack_write_npy failed ({rc}) for {path}")


def write_state_npys(directory: str, state: Dict[str, np.ndarray],
                     n_threads: int = 4) -> None:
    """Write a dict of arrays as <directory>/<name>.npy, n_threads files at
    a time."""
    lib = library()
    os.makedirs(directory, exist_ok=True)
    names = list(state)
    arrays = [np.require(state[name], requirements="C") for name in names]
    n = len(names)
    c_paths = (ctypes.c_char_p * n)(*[
        os.path.join(directory, name + ".npy").encode() for name in names])
    c_codes = (ctypes.c_int * n)(*[_code(a) for a in arrays])
    c_ndims = (ctypes.c_int * n)(*[a.ndim for a in arrays])
    shapes = [(ctypes.c_int64 * a.ndim)(*a.shape) for a in arrays]
    c_shapes = (ctypes.POINTER(ctypes.c_int64) * n)(*shapes)
    c_datas = (ctypes.c_void_p * n)(*[
        a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    rc = lib.fastpack_write_many(n, c_paths, c_codes, c_ndims, c_shapes,
                                 c_datas, n_threads)
    if rc != 0:
        raise IOError(f"fastpack_write_many failed ({rc}) in {directory}")


def read_npy(path: str) -> np.ndarray:
    """Read a .npy file of one of the four dtypes."""
    lib = library()
    code, ndim = ctypes.c_int(), ctypes.c_int()
    shape = (ctypes.c_int64 * 8)()
    size = lib.fastpack_read_npy_info(path.encode(), ctypes.byref(code),
                                      ctypes.byref(ndim), shape)
    if size < 0:
        raise IOError(f"{path}: not a .npy file fastpack reads")
    out = np.empty(tuple(shape[i] for i in range(ndim.value)),
                   dtype=_CODE_DTYPES[code.value])
    got = lib.fastpack_read_npy_data(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), size)
    if got != size:
        raise IOError(f"short read from {path}: {got} != {size}")
    return out
