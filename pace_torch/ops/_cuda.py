"""Build, load and launch the port's hand-written CUDA kernels.

The sources in pace_torch/csrc/*.cu are compiled with nvcc for sm_90a, one
nvcc process a source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  The build happens
at first use, into build/pace_torch/ beside the package, and is redone
whenever the hash of the sources changes.  Every C entry point
takes device pointers, integer sizes, double scalars and the CUDA stream,
and returns cudaGetLastError() of its launches; `launch` raises on a
nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pace_torch"
# -fmad=false: no multiply-add contraction, so a kernel rounds like its
# plain PyTorch version (separate multiply and add) and float64 results
# agree to round-off; see PERF.md for what contraction costs in accuracy
# and gains in time.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


class BuildInfo:
    """What the last build did: library path, seconds, ptxas report."""

    def __init__(self, path, seconds, ptxas):
        self.path = path
        self.seconds = seconds
        self.ptxas = ptxas


_LIB = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_library(sources, lib: pathlib.Path, nvcc=None) -> str:
    """Compile each of `sources` to an object file beside `lib`, one nvcc
    process a source, all started together, then link them into the
    shared library `lib`.  Returns nvcc's output (the ptxas report);
    raises if a step fails."""
    nvcc = nvcc or _nvcc()
    objects, procs = [], []
    for src in map(pathlib.Path, sources):
        obj = lib.with_name(f"{lib.stem}.{src.stem}.{os.getpid()}.o")
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = [proc.communicate()[0] for proc in procs]
    try:
        for src, proc, text in zip(sources, procs, report):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} ({proc.returncode}):\n{text}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(lib),
                               *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):"
                               f"\n{link.stdout}\n{link.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return "".join(report)


def build() -> BuildInfo:
    """Compile csrc/*.cu with NVCC_FLAGS into
    build/pace_torch/libpace_torch_<hash>.so unless that library already
    exists.  Returns the BuildInfo."""
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    lib = BUILD_DIR / f"libpace_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "(cached library, not rebuilt)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    report = compile_library(sources(), tmp)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, report)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build().path))
    return _LIB


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check(*tensors, shape=None, dtype=None):
    """Raise unless every tensor is a contiguous f32/f64 CUDA tensor of the
    given shape and dtype."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the CUDA kernels take CUDA tensors")
        if t.dtype not in _SUFFIX or (dtype is not None and t.dtype != dtype):
            raise TypeError(f"unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(shape)}")


def launch(name: str, dtype: torch.dtype, *tensors, ints=(), floats=()):
    """Call pace_<name>_<f32|f64>(pointers..., ints..., doubles..., stream)
    on the current stream; raise if it reports a CUDA error."""
    lib = library()
    fn = getattr(lib, f"pace_{name}_{_SUFFIX[dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints)
        + [ctypes.c_double] * len(floats) + [ctypes.c_void_p]
    )
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = fn(*(t.data_ptr() for t in tensors), *map(int, ints),
             *map(float, floats), stream)
    if err != 0:
        lib.pace_error_string.restype = ctypes.c_char_p
        lib.pace_error_string.argtypes = [ctypes.c_int]
        text = lib.pace_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel pace_{name} failed: {text} ({err})")
