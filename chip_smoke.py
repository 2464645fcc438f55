#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pace_torch) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):
  0. device and toolchain report;
  1. build the CUDA kernels from pace_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (the transport also at hord 5 and 10; fillz on
     inputs with many negative columns, with few, and with a zero or
     non-finite dp or q planted in columns without negatives), float64
     and float32, with CUDA-event timings and each kernel's bound;
  3. the C12/79 dycore step on the card against the committed digests of
     the reference package (float64 step 1, float32 steps 1-2);
  4. the main path, C48/79 float32, k_split=1, n_split=2, dt=450 s:
     warm-up and timed steps, finite interiors, and the exact launch
     count of every kernel;
  5. the same checks at the dycore settings of
     examples/configs/c96_baroclinic_shield.yaml: C96/79 float32,
     k_split=2, n_split=3, hord 8 and hord_tr 10, dt=300 s (one warm-up
     and two timed steps);
  6. the same checks at the production configuration of bench.py:
     C48/79 float32, k_split=2, n_split=6, dt=450 s (one warm-up and two
     timed steps).
The last three lines are a JSON object with one entry per kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, REPEATS = 3, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=WARMUP, repeats=REPEATS) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def on(arrays, dtype, device="cuda"):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def max_rel(got, ref, region=...) -> tuple:
    """(max |got - ref|, that divided by max |ref| over `region`) over all
    outputs.  Non-finite values must sit at the same places in both (the
    whole-array semantics produce some in never-consumed padding cells);
    the error is taken over the finite ones."""
    err, scale = 0.0, 0.0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(g), test(r)):
                raise AssertionError("non-finite values differ")
        fin = torch.isfinite(r)
        err = max(err, float((g[fin] - r[fin]).abs().max()))
        inside = r[region]
        scale = max(scale,
                    float(inside[torch.isfinite(inside)].abs().max()))
    return err, err / (scale + 1e-300)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per output value, counted from the plain versions' formulas
# (an add, multiply, divide, compare, min/max, abs or transcendental is
# one): K-T per field and point, 4 PPM cells (slope, interface value,
# limited edges: 27 each), 4 fluxes (9), 2 advected values (7) and 2 flux
# combinations (3); K-S per level, about 60 plus 4 transcendentals; K-F
# per level, about 20.
OPS_PER_POINT = {"K-T": 4 * 27 + 4 * 9 + 2 * 7 + 2 * 3, "K-S": 64,
                 "K-F": 20}


def bound(name, inputs, outputs, points) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the HBM rate
    and its operations over the float32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = points * OPS_PER_POINT[name] / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def transport_bound(args):
    """The bound of one transport call: args in TRANSPORT_KEYS order; the
    outputs fx, fy have q_y's shape."""
    q_y = args[0]
    return bound("K-T", args, (q_y, q_y), q_y.numel())

def check_transport(results):
    from pace_torch.ops import fvtp2d
    from pace_torch.testing import TRANSPORT_KEYS, transport_inputs

    # the main path's calls (tracer advection; d_sw's w/q_con/pt and its
    # delp and vorticity; update_dz_d on interfaces), then hord 5 and 10
    cases = [("tracer T=8 hord 8", 8, 79, 8), ("d_sw T=3 hord 6", 3, 79, 6),
             ("d_sw T=1 hord 6", 1, 79, 6),
             ("updatedzd T=1 hord 6 nz+1", 1, 80, 6),
             ("T=3 hord 5", 3, 79, 5), ("T=3 hord 10", 3, 79, 10)]
    for label, T, nz, hord in cases:
        arrays = transport_inputs(48, nz, T)
        for dtype in (torch.float64, torch.float32):
            args = on([arrays[k] for k in TRANSPORT_KEYS], dtype)
            call = (*args, 48, 3, hord)
            plain = fvtp2d.transport_batched_plain(*call)
            kern = fvtp2d.transport_batched_cuda(*call)
            torch.cuda.synchronize()
            # scale: the fluxes on the compute domain's interfaces
            region = (slice(None),) * 2 + (slice(3, 3 + 48 + 1),) * 2
            err, rel = max_rel(kern, plain, region)
            bar = 1e-12 if dtype == torch.float64 else 1e-5
            ok = rel <= bar
            ms = cuda_ms(lambda: fvtp2d.transport_batched_cuda(*call))
            plain_ms = cuda_ms(lambda: fvtp2d.transport_batched_plain(*call),
                               warmup=1, repeats=5)
            bound_ms, bound_by = transport_bound(args)
            log(f"[2] K-T {label} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (bar {bar:g}) kernel={ms:.4f} ms "
                f"plain={plain_ms:.4f} ms "
                + (f"bound={bound_ms:.4f} ms ({bound_by}) "
                   if dtype == torch.float32 else "")
                + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"K-T {label} {dtype}: rel err {rel}")
            if T == 8 and dtype == torch.float32:
                results["K-T"] = (err, ms, plain_ms, bound_ms, bound_by)


def check_sim1(results):
    from pace_torch.ops import riemann
    from pace_torch.testing import sim1_inputs

    arrays = sim1_inputs(56, 56, 79)
    dt, p_fac = 225.0, 0.05
    x64 = on(arrays, torch.float64)
    truth = riemann.sim1_solver_plain(*x64, dt, p_fac)
    kern64 = riemann.sim1_solver_cuda(*x64, dt, p_fac)
    torch.cuda.synchronize()
    err, rel = max_rel(kern64, truth)
    ok = rel <= 1e-12
    log(f"[2] K-S (6,56,56,79) float64: max_abs_err={err:.3e} rel={rel:.3e} "
        f"(bar 1e-12) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K-S float64: rel err {rel}")
    x32 = on(arrays, torch.float32)
    plain32 = riemann.sim1_solver_plain(*x32, dt, p_fac)
    kern32 = riemann.sim1_solver_cuda(*x32, dt, p_fac)
    torch.cuda.synchronize()
    for name, t, p, k in zip(("w", "dz", "pe"), truth, plain32, kern32):
        scale = float(t.abs().max()) + 1e-30
        e_plain = float((t - p.double()).abs().max()) / scale
        e_kern = float((t - k.double()).abs().max()) / scale
        ok = e_kern <= 3.0 * e_plain + 1e-6
        log(f"[2] K-S float32 {name}: kernel err vs f64 {e_kern:.3e}, plain "
            f"err vs f64 {e_plain:.3e} (bar 3*plain+1e-6) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-S float32 {name}: {e_kern} vs {e_plain}")
    err32, _ = max_rel(kern32, plain32)
    ms = cuda_ms(lambda: riemann.sim1_solver_cuda(*x32, dt, p_fac))
    plain_ms = cuda_ms(lambda: riemann.sim1_solver_plain(*x32, dt, p_fac),
                       warmup=1, repeats=5)
    log(f"[2] K-S float32 time: kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
        f"(max_abs_err vs plain {err32:.3e})")
    results["K-S"] = (err32, ms, plain_ms) + bound(
        "K-S", x32, kern32, x32[0].numel())
    log(f"[2] K-S float32 bound={results['K-S'][3]:.4f} ms "
        f"({results['K-S'][4]})")


def check_fillz(results):
    from pace_torch.ops import fillz
    from pace_torch.testing import fillz_inputs, plant_fillz_hazards

    def plain_of(q, dp):
        return torch.stack([fillz.fix_tracer_plain(q[t], dp)
                            for t in range(q.shape[0])])

    # many negative columns (every column takes the recurrence), few (most
    # leave as a copy), and the values that forbid the copy planted in
    # columns without negatives
    few = fillz_inputs(9, 56, 56, 79, neg_frac=1e-4)
    cases = [("neg_frac 0.3", fillz_inputs(9, 56, 56, 79), True),
             ("neg_frac 1e-4", few, True),
             ("neg_frac 1e-4, planted dp = 0 and non-finite dp, q",
              plant_fillz_hazards(*few), False)]
    for label, arrays, timed in cases:
        for dtype in (torch.float64, torch.float32):
            q, dp = on(arrays, dtype)
            plain = plain_of(q, dp)
            kern = fillz.fix_tracers_cuda(q, dp)
            torch.cuda.synchronize()
            err, rel = max_rel([kern], [plain])
            bar = 1e-12 if dtype == torch.float64 else 1e-5
            ok = rel <= bar
            negative = float((q < 0).any(-1).float().mean())
            text = (f"[2] K-F (9,6,56,56,79) {label} {str(dtype)[6:]}: "
                    f"{negative:.4f} of columns hold a negative, "
                    f"{int((~torch.isfinite(plain)).sum())} non-finite "
                    f"outputs, max_abs_err={err:.3e} rel={rel:.3e} "
                    f"(bar {bar:g}) ")
            if not ok:
                log(text + "FAIL")
                raise AssertionError(f"K-F {label} {dtype}: rel err {rel}")
            if not timed:
                log(text + "ok")
                continue
            ms = cuda_ms(lambda: fillz.fix_tracers_cuda(q, dp))
            plain_ms = cuda_ms(lambda: plain_of(q, dp), warmup=1, repeats=3)
            bound_ms, bound_by = bound("K-F", (q, dp), (kern,), q.numel())
            log(text + f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                + (f"bound={bound_ms:.4f} ms ({bound_by}) "
                   if dtype == torch.float32 else "") + "ok")
            if dtype == torch.float32 and "K-F" not in results:
                results["K-F"] = (err, ms, plain_ms, bound_ms, bound_by)


# ---------------------------------------------------------------------------
# phases 3 to 6: the dycore step
# ---------------------------------------------------------------------------

def make_core(n, dtype, dt, **settings):
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(n, 79)
    gd = generate_grid_data(n, 79, device="cuda", dtype=dtype)
    config = DynamicalCoreConfig(do_sat_adj=False, **settings)
    core = DynamicalCore(config, sizing, gd, timestep=dt)
    state = init_baroclinic_state(sizing, device="cuda", dtype=dtype)
    return sizing, core, state


def check_c12_digests():
    from pace_torch.testing import digest_errors, state_digest

    golden = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(golden, "c12_dycore_digest.json")) as f:
        ref64 = json.load(f)
    with open(os.path.join(golden, "c12_dycore_digest_f32.json")) as f:
        ref32 = json.load(f)

    sizing, core, state = make_core(12, torch.float64, 225.0)
    truth = []
    for _ in range(2):
        state = core.step_dynamics(state)
        truth.append(state_digest(state, sizing))
    errs = digest_errors(truth[0], ref64["step1"])
    worst = max(errs, key=errs.get)
    ok = errs[worst] <= 1e-9
    log(f"[3] C12/79 float64 step 1 vs reference digest: worst field "
        f"{worst} rel err {errs[worst]:.3e} (bar 1e-9) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"C12 f64 digest: {worst} {errs[worst]}")

    sizing, core, state = make_core(12, torch.float32, 225.0)
    for i in (1, 2):
        state = core.step_dynamics(state)
        got = state_digest(state, sizing)
        ref = ref32[f"step{i}"]
        err_ref = digest_errors(got, ref)
        err_truth = digest_errors(got, truth[i - 1])
        ref_truth = digest_errors(ref, truth[i - 1])
        for name, e in err_ref.items():
            # a float32 run is held to the reference's float32 digest at
            # 1e-3 of field scale, or, where float32 rounding of the
            # reference itself reaches that, to no more than 1.5x the
            # reference's own float32 error against the float64 run
            if e <= 1e-3:
                continue
            ok = err_truth[name] <= 1.5 * ref_truth[name]
            log(f"[3] C12/79 float32 step {i} {name}: rel err {e:.3e} vs "
                f"reference digest; vs float64 {err_truth[name]:.3e}, "
                f"reference's own float32 error {ref_truth[name]:.3e} "
                f"(bar 1.5x) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"C12 f32 step{i} {name}: {e} vs reference digest, "
                    f"{err_truth[name]} vs f64 (reference's own "
                    f"{ref_truth[name]})")
        worst = max(err_ref, key=err_ref.get)
        log(f"[3] C12/79 float32 step {i} vs reference digest: worst field "
            f"{worst} rel err {err_ref[worst]:.3e}; vs float64 "
            f"{err_truth[worst]:.3e}, reference's own float32 error "
            f"{ref_truth[worst]:.3e} ok")


def expected_launches(config) -> dict:
    """Kernel launches per step implied by the configuration: d_sw runs one
    transport for delp, one per distinct PPM order of (w, q_con, pt) and
    one for the vorticity; update_dz_d one; tracer advection three; the two
    Riemann solvers one SIM1 each; each remap one fillz."""
    d_sw = 2 + len({config.hord_vt, config.hord_dp, config.hord_tm})
    acoustic = config.n_split * (d_sw + 1)
    return {
        "K-T": config.k_split * (acoustic + 3),
        "K-S": config.k_split * config.n_split * 2,
        "K-F": config.k_split * (1 if config.fill else 0),
    }


# The dycore settings of examples/configs/c96_baroclinic_shield.yaml
# (hord 8 everywhere, hord_tr 10, k_split 2, n_split 3, dt 300 s).
SHIELD = dict(k_split=2, n_split=3, hord_mt=8, hord_vt=8, hord_tm=8,
              hord_dp=8, hord_tr=10, rf_fast=True, tau=10.0, d_con=1.0,
              n_sponge=48)


def run_path(tag, n, dt, warmup, timed, card, **settings) -> dict:
    """Drive DynamicalCore.step_dynamics at C`n`/79 float32 with the launch
    counts set to 0 just before and read just after; check every
    prognostic interior is finite and every kernel ran exactly as often as
    the configuration implies.  Returns the launch counts."""
    from pace_torch.ops import fillz, fvtp2d, riemann

    counters = {"K-T": fvtp2d, "K-S": riemann, "K-F": fillz}
    t0 = time.perf_counter()
    sizing, core, state = make_core(n, torch.float32, dt, **settings)
    torch.cuda.synchronize()
    label = " ".join(f"{k}={v}" for k, v in settings.items())
    log(f"[{tag}] C{n}/79 float32 {label} dt={dt:g}: set-up "
        f"{time.perf_counter() - t0:.2f} s")
    for mod in counters.values():
        mod.LAUNCHES = 0
    for _ in range(warmup):
        state = core.step_dynamics(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state = core.step_dynamics(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}

    h = sizing.halo
    for name in ("u", "v", "w", "delp", "delz", "pt", "qvapor", "ps",
                 "pe", "pk", "pkz", "peln", "ua", "va", "omga"):
        interior = getattr(state, name)[:, h:h + n, h:h + n]
        if not bool(torch.isfinite(interior).all()):
            raise AssertionError(f"C{n}: {name} interior not finite")
    log(f"[{tag}] every prognostic field's compute interior is finite")

    per_step = expected_launches(core.config)
    steps = warmup + timed
    for name, count in launches.items():
        expect = per_step[name] * steps
        log(f"[{tag}] {name} launches: expected {expect} "
            f"({per_step[name]}/step x {steps}), got {count}")
        if count != expect or count == 0:
            raise AssertionError(f"{name}: {count} launches, expected {expect}")
    log(f"[{tag}] info: {ms:.3f} ms/step, {dt / (ms / 1e3):.1f} sim-days/day "
        f"({timed} steps after {warmup} warm-up) on {card}")
    return launches


KERNELS = {
    "K-T": dict(name="fvtp2d transport_batched", source="pace_torch/csrc/fvtp2d.cu",
                replaces="pace_tpu/ops/pallas/fvtp2d_pallas.py:217"),
    "K-S": dict(name="sim1 solver", source="pace_torch/csrc/sim1.cu",
                replaces="pace_tpu/ops/pallas/sim1_pallas.py:202"),
    "K-F": dict(name="fillz fix_tracer", source="pace_torch/csrc/fillz.cu",
                replaces="pace_tpu/ops/pallas/fillz_pallas.py:135"),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    sys.path.insert(0, REPO)
    from pace_torch.ops import _cuda

    started = time.perf_counter()

    # ---- phase 0
    card = card_line()
    log(f"[0] device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {card}")
    # a separate interpreter, so this process never loads JAX
    jax_probe = subprocess.run(
        [sys.executable, "-c",
         "import importlib; importlib.import_module('jax')"],
        capture_output=True, text=True)
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"JAX {'imports' if jax_probe.returncode == 0 else 'does not import'}"
        f" on this machine (the port does not use it); TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    torch.cuda.set_device(0)

    # ---- phase 1
    info = _cuda.build()
    log(f"[1] built {os.path.relpath(info.path, REPO)} in "
        f"{info.seconds:.1f} s")
    for line in info.ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[1] {line.strip()}")

    # ---- phase 2
    results = {}
    check_transport(results)
    check_sim1(results)
    check_fillz(results)

    # ---- phase 3
    check_c12_digests()

    # ---- phase 4: the main path
    launches = run_path(4, 48, 450.0, 2, 5, card, k_split=1, n_split=2)

    # ---- phase 5: the C96 SHiELD-like settings
    run_path(5, 96, 300.0, 1, 2, card, **SHIELD)

    # ---- phase 6: the production configuration of bench.py
    run_path(6, 48, 450.0, 1, 2, card, k_split=2, n_split=6)
    log(f"[6] all phases took {time.perf_counter() - started:.0f} s")

    kernels = [
        dict(**KERNELS[k], route="cuda", launches=launches[k],
             max_abs_err=results[k][0], ms=results[k][1],
             plain_ms=results[k][2], bound_ms=results[k][3],
             bound_by=results[k][4], library_ms=None)
        for k in ("K-T", "K-S", "K-F")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
