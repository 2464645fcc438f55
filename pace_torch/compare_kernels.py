"""Time the transport (K-T), SIM1 (K-S) and fillz (K-F) kernels against an
earlier version of their sources, on one GPU, in one process.

    git show <commit>:pace_torch/csrc/fvtp2d.cu > build/earlier/fvtp2d.cu
    git show <commit>:pace_torch/csrc/sim1.cu > build/earlier/sim1.cu
    git show <commit>:pace_torch/csrc/fillz.cu > build/earlier/fillz.cu
    python -m pace_torch.compare_kernels build/earlier

Only the kernels whose source the directory holds are compared.  An
earlier fvtp2d.cu or sim1.cu must have the C interface of the first CUDA
port (pace_fvtp2d_* with four scratch fields before fx and fy, hord 6 or
8; pace_sim1_* with one scratch buffer of pace_sim1_scratch_slots() rows);
pace_fillz_* has kept its interface.  The sources are built with the same
nvcc flags into build/pace_torch/earlier/.

The inputs, all at C48/79 float32:
  - synthetic: pace_torch.testing's seeded inputs (chip_smoke.py phase 2):
    transport T=8 at hord 8, SIM1 on (6, 56, 56, 79), fillz on
    (9, 6, 56, 56, 79) with 30% negative values and, as "synthetic mostly
    clean", with one value in 10,000 negative;
  - step: the arguments of the first T=8 transport call (tracer
    advection), of the first SIM1 call and of the fillz call of a C48/79
    k_split=1 n_split=2 step, captured after two warm-up steps.
Each kernel is timed with CUDA events (20 launches after 3 warm-up, each
through a wrapper that allocates its outputs as the port's does) in turns:
earlier, current, current, earlier.  The results of the two versions are
compared element by element.  Prints one JSON line per measurement and the
card's name and power limit.  For K-T a line also holds the share of warps
of the earlier kernel whose Courant numbers, crx and cry, take both signs;
for K-F the share of columns that hold a negative value, the share of
runs of 32 consecutive columns that hold such a column (one warp of the
current kernel's recurrence) and the share of columns with a zero or
non-finite dp.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys

import torch

from pace_torch.ops import _cuda, fillz, fvtp2d, riemann

WARMUP, REPEATS = 3, 20
SOURCES = {"K-T": "fvtp2d.cu", "K-S": "sim1.cu", "K-F": "fillz.cu"}


def cuda_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPEATS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPEATS


def build_earlier(src_dir: pathlib.Path) -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "earlier"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libearlier.so"
    sources = [str(src_dir / name) for name in SOURCES.values()
               if (src_dir / name).exists()]
    if not sources:
        raise SystemExit(f"no kernel source in {src_dir}")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                           *sources], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _fn(lib, name, n_ptr, n_int, n_float):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_double] * n_float + [ctypes.c_void_p])
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def earlier_transport(lib):
    fns = {torch.float32: _fn(lib, "pace_fvtp2d_f32", 17, 6, 0),
           torch.float64: _fn(lib, "pace_fvtp2d_f64", 17, 6, 0)}

    def run(q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area, n, h,
            hord):
        T, _, N, _, nz = q_y.shape
        scratch = [torch.empty_like(q_y) for _ in range(4)]
        fx, fy = torch.empty_like(q_y), torch.empty_like(q_y)
        ptrs = [t.data_ptr() for t in (q_y, q_x, crx, cry, xfx, yfx, xmf,
                                       ymf, dxa, dya, area, *scratch, fx, fy)]
        err = fns[q_y.dtype](*ptrs, T, N, nz, n, h, hord, _stream(q_y))
        if err:
            raise RuntimeError(f"earlier transport kernel failed ({err})")
        return fx, fy

    return run


def earlier_sim1(lib):
    fns = {torch.float32: _fn(lib, "pace_sim1_f32", 12, 2, 2),
           torch.float64: _fn(lib, "pace_sim1_f64", 12, 2, 2)}
    lib.pace_sim1_scratch_slots.restype = ctypes.c_int
    slots = lib.pace_sim1_scratch_slots()

    def run(w, dm, gm, dz, pt, pm, pem, ws, dt, p_fac):
        nz = w.shape[-1]
        ncol = w.numel() // nz
        scratch = torch.empty((slots, nz + 1, ncol), dtype=w.dtype,
                              device=w.device)
        outs = (torch.empty_like(w), torch.empty_like(w),
                torch.empty_like(pem))
        ptrs = [t.data_ptr() for t in (w, dm, gm, dz, pt, pm, pem, ws,
                                       *outs, scratch)]
        err = fns[w.dtype](*ptrs, ncol, nz, float(dt), float(p_fac),
                           _stream(w))
        if err:
            raise RuntimeError(f"earlier SIM1 kernel failed ({err})")
        return outs

    return run


def earlier_fillz(lib):
    fns = {torch.float32: _fn(lib, "pace_fillz_f32", 3, 3, 0),
           torch.float64: _fn(lib, "pace_fillz_f64", 3, 3, 0)}

    def run(q, dp):
        nz = q.shape[-1]
        out = torch.empty_like(q)
        err = fns[q.dtype](q.data_ptr(), dp.data_ptr(), out.data_ptr(),
                           q.shape[0], dp.numel() // nz, nz, _stream(q))
        if err:
            raise RuntimeError(f"earlier fillz kernel failed ({err})")
        return (out,)

    return run


def current_fillz(q, dp):
    return (fillz.fix_tracers_cuda(q, dp),)


def synthetic_inputs() -> dict:
    """label -> kernel -> arguments, on the card."""
    from pace_torch.testing import TRANSPORT_KEYS, fillz_inputs, \
        sim1_inputs, transport_inputs

    def on(arrays):
        return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                for a in arrays]

    arrays = transport_inputs(48, 79, 8)
    return {
        "synthetic": {
            "K-T": (*on(arrays[k] for k in TRANSPORT_KEYS), 48, 3, 8),
            "K-S": (*on(sim1_inputs(56, 56, 79)), 225.0, 0.05),
            "K-F": tuple(on(fillz_inputs(9, 56, 56, 79))),
        },
        "synthetic mostly clean": {
            "K-F": tuple(on(fillz_inputs(9, 56, 56, 79, neg_frac=1e-4))),
        },
    }


def step_inputs() -> dict:
    """The arguments of the first T=8 transport call, the first SIM1 call
    and the fillz call of a C48/79 f32 k1/n2 step, after two warm-up
    steps."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(48, 79)
    core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False, n_split=2),
                         sizing, generate_grid_data(48, 79), timestep=450.0)
    state = init_baroclinic_state(sizing)
    for _ in range(2):
        state = core.step_dynamics(state)
    got = {}
    kt, ks = fvtp2d.transport_batched_cuda, riemann.sim1_solver_cuda
    kf = fillz.fix_tracers_cuda

    def keep(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def grab_kt(*args):
        if "K-T" not in got and args[0].shape[0] == 8:
            got["K-T"] = keep(args)
        return kt(*args)

    def grab_ks(*args):
        got.setdefault("K-S", keep(args))
        return ks(*args)

    def grab_kf(*args):
        got.setdefault("K-F", keep(args))
        return kf(*args)

    fvtp2d.transport_batched_cuda = grab_kt
    riemann.sim1_solver_cuda = grab_ks
    fillz.fix_tracers_cuda = grab_kf
    try:
        core.step_dynamics(state)
    finally:
        fvtp2d.transport_batched_cuda = kt
        riemann.sim1_solver_cuda = ks
        fillz.fix_tracers_cuda = kf
    return got


def mixed_sign(courant) -> float:
    """The share of 32 consecutive values (k fastest: the threads of one
    warp of the earlier transport kernel) whose Courant numbers take both
    signs, so that a warp runs both branches of the PPM flux."""
    flat = courant.reshape(-1)
    chunks = flat[: flat.numel() // 32 * 32].view(-1, 32) > 0
    return float((chunks.any(1) & ~chunks.all(1)).float().mean())


def fillz_columns(q, dp) -> dict:
    """The shares of columns (k last) that hold a negative value, of runs
    of 32 consecutive columns of a tracer that hold such a column, and of
    columns whose dp holds a zero or a non-finite value (which take the
    recurrence without a negative)."""
    neg = (q < 0).any(-1).reshape(q.shape[0], -1)
    runs = neg[:, : neg.shape[1] // 32 * 32].reshape(q.shape[0], -1, 32)
    bad_dp = ((dp == 0) | ~torch.isfinite(dp)).any(-1)
    return dict(negative_columns=float(neg.float().mean()),
                negative_runs_of_32=float(runs.any(-1).float().mean()),
                zero_or_nonfinite_dp_columns=float(bad_dp.float().mean()))


def compare(name, inputs, label, earlier, current, card):
    old = earlier(*inputs)
    new = current(*inputs)
    torch.cuda.synchronize()
    diff, unlike = 0.0, 0
    for o, c in zip(old, new):
        fin = torch.isfinite(o) & torch.isfinite(c)
        unlike += int((torch.isfinite(o) != torch.isfinite(c)).sum())
        diff = max(diff, float((o[fin] - c[fin]).abs().max()))
    times = [cuda_ms(lambda: earlier(*inputs)),
             cuda_ms(lambda: current(*inputs)),
             cuda_ms(lambda: current(*inputs)),
             cuda_ms(lambda: earlier(*inputs))]
    extra = {}
    if name == "K-T":
        extra["mixed_sign_warps"] = [mixed_sign(c) for c in inputs[2:4]]
    if name == "K-F":
        extra.update(fillz_columns(*inputs))
    row = dict(kernel=name, inputs=label, **extra,
               shape=list(inputs[0].shape), dtype=str(inputs[0].dtype),
               earlier_ms=[times[0], times[3]],
               current_ms=[times[1], times[2]],
               ratio=(times[1] + times[2]) / (times[0] + times[3]),
               max_abs_diff=diff, nonfinite_cells_differ=unlike, card=card)
    print(json.dumps(row), flush=True)
    if unlike:
        raise AssertionError(f"{name} {label}: non-finite cells differ")


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    src_dir = pathlib.Path(os.path.abspath(sys.argv[1]))
    lib = build_earlier(src_dir)
    _cuda.library()
    versions = {
        "K-T": (earlier_transport, fvtp2d.transport_batched_cuda),
        "K-S": (earlier_sim1, riemann.sim1_solver_cuda),
        "K-F": (earlier_fillz, current_fillz),
    }
    for label, inputs in {**synthetic_inputs(), "step": step_inputs()}.items():
        for name, args in inputs.items():
            if (src_dir / SOURCES[name]).exists():
                earlier, current = versions[name]
                compare(name, args, label, earlier(lib), current, card)


if __name__ == "__main__":
    main()
