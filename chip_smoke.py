#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pace_torch) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:  python3 chip_smoke.py
(`python3 chip_smoke.py --phases 2,15` runs phases 0 and 1 and those
named, and prints no result lines.)

Phases (any failure raises and exits non-zero; nothing falls back):
  0. device and toolchain report;
  1. build the CUDA kernels from pace_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (the transport also at hord 5 and 10; fillz on
     inputs with many negative columns, with few, and with a zero or
     non-finite dp or q planted in columns without negatives), float64
     and float32, with CUDA-event timings and each kernel's bound; then
     K-T (T=8 hord 8, T=1 hord 6), K-S and K-F at the tile counts of a
     rank, 1 and 3 tiles of the same inputs, and on the blocks of ranks
     that split tiles: rank 0 of (1, 2, 4) (six tiles of 31 x 19 points)
     and of (6, 4, 4) (a tile's corner, 19 x 19), K-T in float64 exactly
     equal to its plain version;
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
     timed steps);
  7. the coupled model step behind `pace_torch.driver.Driver`, C48/79
     float32, dt=225 s, k_split=1, n_split=2, do_sat_adj, fv_sg_adj=3600,
     n_sponge=48, GFDL microphysics with mp_time=225 (the settings of
     examples/configs/baroclinic_c12_coupled.yaml at C48): one warm-up and
     three timed steps with the dycore and physics halves timed apart,
     finite interiors, pt within 150-350 K, delp > 0, the dycore half's
     exact launch counts, and the column water budget of the physics half
     (also on a step from a moistened state, where it rains);
  7b. the C12/79 float64 coupled step on the card against the same step of
     the port on the CPU, every field within 1e-9 of its scale;
  8. the coupled step with the MLP emulator as the microphysics scheme, at
     the dycore settings of examples/configs/c384_multihost_emulator.yaml
     and C96/79 float32, with seeded weights and a non-zero output layer:
     one warm-up and two timed steps, finite interiors, exact launch
     counts and the emulator's water conservation;
  9. the yaml entry point, `pace_torch.driver.run.main`, on copies of the
     example configurations (only output paths, run length and, where
     stated, the restart section changed): baroclinic_c12.yaml on the card
     and on the CPU (restarts within 1e-9) and for one step with a Chrome
     trace (profile_dir) that holds every kernel launch,
     baroclinic_c12_coupled.yaml,
     c48_sections_perf.yaml with a step-3 restart that a second run
     continues to the same final state bit for bit,
     c96_baroclinic_shield.yaml, tropical_cyclone_c48.yaml cut to 4 steps
     (vortex checks); each run's diagnostics, perf JSON, restart,
     safety checks and exact launch counts; and c384_multihost_emulator.
     yaml's [6, 4, 4] mesh built at n = 384 without a process group: its
     96 boxes and rank 0's exchange plans, rows received per halo kind and
     bytes a step (the halo calls of the yaml's step, recorded at C12);
  10. the dycore branches kord 8, kord 10, do_skeb and the dynamic tracer
     subcycle: each as one C12/79 float64 step on the card against the same
     step on the CPU (every field within 1e-9 of its scale; for kord 10,
     which branches on exact ties, the step is reported and its remap
     operators are held at 1e-9 on the same columns on both devices), and
     as two C48/79 float32 steps on the card with finite interiors and
     exact launch counts (under the subcycle, the transport's launches are
     the trip counts it took plus d_sw's);
  11. the JW day-1 anchor: 192 steps of the C12/79 float64 baroclinic wave
     (k_split=1, n_split=4, dt=450 s) on the card, its digest within 1e-7
     of tests/golden/jw_day1_c12_f64.json;
  12. the other entry points: `pace_torch.driver.run` from a six-tile
     Fortran restart of the baroclinic C12 start (written here with scipy)
     for two steps, its first state the written one and its run finite; one
     GeosDycoreWrapper call, equal bit for bit to a DynamicalCore step on
     the same inputs; one C12 step under a checkpointer, whose savepoints
     come in the reference's order;
  13. the savepoint harness: every registered translate case at C12/79
     float64 with 6 ranks, and the cases of the kernels' operators at
     C48/79 float64 with 54 ranks (3x3 a tile), each computed on the CPU,
     written as a savepoint pair, read back and validated on the card at
     its own threshold, with K-T, K-S and K-F launched on the way;
     `python -m pace_torch.driver.tools memory` and `cost` on a copy of
     c48_sections_perf.yaml (state bytes, temporary memory, the kernel
     counts of a step) and `cost` of baroclinic_c12.yaml equal on the card
     and the CPU; the native restart writer built, a restart through it
     read back, and one C48 restart written through it and through
     numpy.save in turns, timed;
  14. ranks of a (t, 1, 1) layout on the one card, started through
     torchrun (`chip_smoke.py --ranks DIR` is one rank), exchanging
     through gloo with pinned-host staging: two C12/79 float64 steps under
     pair_debug against the one-rank card step at (6, 1, 1) and (2, 1, 1);
     C192/79 float32 k1/n6 at (6, 1, 1), one warm-up and three timed steps
     (launches, exchange bytes from the plan and exchange ms from CUDA
     events a step, memory and ms/step of each rank), the gathered state
     against four steps of one process on the whole cube; then
     c48_sections_perf.yaml at layout [6, 1, 1] through `torchrun -m
     pace_torch.driver.run`, its restarts and diagnostics against phase
     9's one-rank run; one C12 tile stepped alone from a halo-traffic
     recording;
  15. ranks that split tiles along x and y, eight on the one card through
     torchrun (`chip_smoke.py --split-ranks DIR` is one rank), gloo with
     pinned-host staging: two C12/79 float64 steps under pair_debug
     against the one-rank card step at (1, 2, 2), (2, 2, 2) and (1, 2, 4);
     phase 8's coupled emulator step (the settings of
     c384_multihost_emulator.yaml at C96/79 float32) at (2, 2, 2), one
     warm-up and two timed steps, the gathered state against one process
     (launches, exchanges, bytes and exchange ms, memory and ms/step of
     each rank); then c384_multihost_emulator.yaml cut to nx_tile 24,
     layout [6, 2, 2], multihost false and 2 steps through `torchrun -m
     pace_torch.driver.run` (24 ranks), its files against the one-rank run
     of the same cut yaml;
  16. each rank builds only its own block of the grid and of the initial
     state: 16.1, ranks 0, 1, 5 and 95 of c384_multihost_emulator.yaml's
     [6, 4, 4] mesh at n = 384 (a tile's south-west corner, a west edge,
     an interior box, tile 5's north-east corner), each built alone in a
     process of its own (`chip_smoke.py --local-build DIR RANK`; its
     metric terms evaluated at its block's points), grid and state
     float32 on the card, and the whole cube built as one process builds
     it: each rank's float64 host arrays of grid and state identical to
     the whole cube's cut bit for bit, every leaf (the four area extremes
     among them); the host memory each rank's build adds to its process
     at most 0.10 of what the whole cube's adds (with seconds, device
     bytes and the host bytes after each stage); 16.3, rank 0 of that
     mesh writes a float32 restart and one diagnostics record of the
     yaml's names (`chip_smoke.py --root-write DIR WHICH SEED`), the 95
     other ranks' blocks made from a seed one at a time by a stand-in for
     the gather: the files read back equal to every rank's block, each
     write adding at most three whole-cube fields to the host; then 16.2,
     that yaml cut to nx_tile 96 at [6, 2, 2] (24 ranks of 48 x 48 cells;
     at 192 the 24 ranks outgrow the card), 2 steps through `torchrun -m
     pace_torch.driver.run` against its one-rank run (which runs beside
     16.1 and 16.3), rank 0's and the other ranks' host peaks, card peaks
     and initialization from the perf JSON.
The last three lines are a JSON object with one entry per kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
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

# The bound model (the larger of bytes over the HBM rate and operations
# over the float32 rate) and the kernels' names live in the package, where
# `python -m pace_torch.driver.tools cost` reads them too.
from pace_torch.ops.bounds import KERNELS, bound  # noqa: E402
from pace_torch.utils.gridtools import Domain  # noqa: E402


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
            call = (*args, Domain.whole(48, 3), hord)
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


def check_rank_shapes():
    """The three kernels at the tile counts of a rank of a (2, 1, 1) or
    (6, 1, 1) layout (3 and 1 tiles), C48 shapes, against their plain
    versions on the same inputs: tiles [0, 1) and [3, 6) of the six-tile
    inputs."""
    from pace_torch.ops import fillz, fvtp2d, riemann
    from pace_torch.testing import (
        TRANSPORT_KEYS,
        fillz_inputs,
        sim1_inputs,
        transport_inputs,
    )

    def tiles_of(a, t0, t1, axis=0):
        return np.ascontiguousarray(np.take(a, range(t0, t1), axis=axis))

    cases = []
    for T, hord in ((8, 8), (1, 6)):
        full = transport_inputs(48, 79, T)
        for t0, t1 in ((0, 1), (3, 6)):
            arrays = [tiles_of(full[k], t0, t1, int(k in ("q_y", "q_x")))
                      for k in TRANSPORT_KEYS]
            cases.append((
                f"K-T T={T} hord {hord}", t1 - t0, arrays, "K-T",
                lambda *a, hord=hord: fvtp2d.transport_batched_plain(
                    *a, Domain.whole(48, 3), hord),
                lambda *a, hord=hord: fvtp2d.transport_batched_cuda(
                    *a, Domain.whole(48, 3), hord),
                (slice(None),) * 2 + (slice(3, 52),) * 2))
    dt, p_fac = 225.0, 0.05
    full = sim1_inputs(56, 56, 79)
    q, dp = fillz_inputs(9, 56, 56, 79)
    for t0, t1 in ((0, 1), (3, 6)):
        cases.append((
            "K-S", t1 - t0, [tiles_of(a, t0, t1) for a in full], "K-S",
            lambda *a: riemann.sim1_solver_plain(*a, dt, p_fac),
            lambda *a: riemann.sim1_solver_cuda(*a, dt, p_fac), ...))
        cases.append((
            "K-F neg_frac 0.3", t1 - t0,
            [tiles_of(q, t0, t1, 1), tiles_of(dp, t0, t1)], "K-F",
            lambda q, dp: [torch.stack([fillz.fix_tracer_plain(x, dp)
                                        for x in q])],
            lambda q, dp: [fillz.fix_tracers_cuda(q, dp)], ...))
    for label, tiles, arrays, key, plain_fn, kern_fn, region in cases:
        for dtype in (torch.float64, torch.float32):
            args = on(arrays, dtype)
            plain, kern = plain_fn(*args), kern_fn(*args)
            torch.cuda.synchronize()
            err, rel = max_rel(kern, plain, region)
            bar = 1e-12 if dtype == torch.float64 else 1e-5
            ms = cuda_ms(lambda: kern_fn(*args))
            text = ""
            if dtype == torch.float32:
                plain_ms = cuda_ms(lambda: plain_fn(*args), warmup=1,
                                   repeats=3)
                bound_ms, bound_by = bound(key, args, kern, args[0].numel())
                text = (f"plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms "
                        f"({bound_by}) ")
            log(f"[2] {label} at {tiles} tile{'s' * (tiles > 1)} "
                f"{str(dtype)[6:]}: max_abs_err={err:.3e} rel={rel:.3e} "
                f"(bar {bar:g}) kernel={ms:.4f} ms " + text
                + ("ok" if rel <= bar else "FAIL"))
            if not rel <= bar:
                raise AssertionError(f"{label} at {tiles} tiles {dtype}: "
                                     f"rel err {rel}")


def check_split_shapes():
    """The kernels on the block a rank of an x/y layout holds, C48 inputs
    cut to it, against their plain versions on the same block: K-T (T=8
    hord 8 and T=1 hord 6) on rank 0 of (1, 2, 4) (six tiles of 31 x 19
    points, tile edges on its west and south sides) and on rank 0 of
    (6, 4, 4) (one tile's corner block of 19 x 19 points); K-S and K-F on
    the (1, 2, 4) block.  K-T in float64 exactly equal."""
    from pace_torch.ops import fillz, fvtp2d, riemann
    from pace_torch.parallel.partition import Partition
    from pace_torch.testing import (
        TRANSPORT_KEYS,
        fillz_inputs,
        sim1_inputs,
        transport_inputs,
    )

    cases = []
    full = {T: transport_inputs(48, 79, T) for T in (8, 1)}
    for layout in ((1, 2, 4), (6, 4, 4)):
        partition = Partition(layout, 48)
        dom, box = partition.domain(0), partition.local_box(0)
        shape = f"{layout} rank 0, ({box.shape[0]},{dom.Ni},{dom.Nj})"
        for T, hord in ((8, 8), (1, 6)):
            arrays = [np.ascontiguousarray(
                full[T][k][(slice(None),) + box.index]
                if k in ("q_y", "q_x") else full[T][k][box.index])
                for k in TRANSPORT_KEYS]
            cases.append((
                f"K-T T={T} hord {hord} {shape}", arrays, "K-T",
                lambda *a, hord=hord, dom=dom:
                    fvtp2d.transport_batched_plain(*a, dom, hord),
                lambda *a, hord=hord, dom=dom:
                    fvtp2d.transport_batched_cuda(*a, dom, hord)))
    dom = Partition((1, 2, 4), 48).domain(0)
    dt, p_fac = 225.0, 0.05
    cases.append((f"K-S (6,{dom.Ni},{dom.Nj},79)",
                   list(sim1_inputs(dom.Ni, dom.Nj, 79)), "K-S",
                   lambda *a: riemann.sim1_solver_plain(*a, dt, p_fac),
                   lambda *a: riemann.sim1_solver_cuda(*a, dt, p_fac)))
    cases.append((f"K-F neg_frac 0.3 (9,6,{dom.Ni},{dom.Nj},79)",
                   list(fillz_inputs(9, dom.Ni, dom.Nj, 79)), "K-F",
                   lambda q, dp: [torch.stack([fillz.fix_tracer_plain(x, dp)
                                               for x in q])],
                   lambda q, dp: [fillz.fix_tracers_cuda(q, dp)]))
    for label, arrays, key, plain_fn, kern_fn in cases:
        for dtype in (torch.float64, torch.float32):
            args = on(arrays, dtype)
            plain, kern = plain_fn(*args), kern_fn(*args)
            torch.cuda.synchronize()
            err, rel = max_rel(kern, plain)
            exact = key == "K-T" and dtype == torch.float64
            bar = 1e-12 if dtype == torch.float64 else 1e-5
            ok = err == 0.0 if exact else rel <= bar
            text = ""
            if dtype == torch.float32:
                ms = cuda_ms(lambda: kern_fn(*args))
                plain_ms = cuda_ms(lambda: plain_fn(*args), warmup=1,
                                   repeats=3)
                bound_ms, bound_by = bound(key, args, kern, args[0].numel())
                text = (f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                        f"bound={bound_ms:.4f} ms ({bound_by}) "
                        f"share={bound_ms / ms:.3f} ")
            log(f"[2] split block {label} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} rel={rel:.3e} "
                f"(bar {'exactly 0' if exact else f'{bar:g}'}) " + text
                + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"split block {label} {dtype}: err "
                                     f"{err} rel {rel}")


# ---------------------------------------------------------------------------
# phases 3 to 6: the dycore step
# ---------------------------------------------------------------------------

def make_core(n, dtype, dt, device="cuda", part=None, topology=None,
              **settings):
    """A baroclinic C`n`/79 dycore and its start: of the whole cube, or
    with `part` (`Partition.part(rank)`) and a rank `topology`, of one
    rank's block (grid and state built on the block alone)."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(n, 79)
    gd = generate_grid_data(n, 79, device=device, dtype=dtype,
                            part=part)
    config = DynamicalCoreConfig(do_sat_adj=False, **settings)
    core = DynamicalCore(config, sizing, gd, timestep=dt, topology=topology)
    state = init_baroclinic_state(sizing, device=device, dtype=dtype,
                                  part=part)
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


def _counters() -> dict:
    from pace_torch.ops import fillz, fvtp2d, riemann

    return {"K-T": fvtp2d, "K-S": riemann, "K-F": fillz}


def reset_launches() -> None:
    for mod in _counters().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


PROGNOSTICS = ("u", "v", "w", "delp", "delz", "pt", "qvapor", "qliquid",
               "qrain", "qice", "qsnow", "qgraupel", "qcld", "ps", "pe", "pk",
               "pkz", "peln", "ua", "va", "omga")


def check_finite(tag, state, sizing) -> None:
    h, n = sizing.halo, sizing.n
    for name in PROGNOSTICS:
        interior = getattr(state, name)[:, h:h + n, h:h + n]
        if not bool(torch.isfinite(interior).all()):
            raise AssertionError(f"C{n}: {name} interior not finite")
    log(f"[{tag}] every prognostic field's compute interior is finite")


def check_launches(tag, launches, config, steps, tracer_trips=None) -> None:
    """Each kernel launched as often as `steps` steps of the configuration
    imply; `tracer_trips`, the dynamic subcycle's trip counts summed over
    the steps, replaces tracer advection's fixed three a step."""
    per_step = expected_launches(config)
    for name, count in launches.items():
        expect = per_step[name] * steps
        how = f"{per_step[name]}/step x {steps}"
        if name == "K-T" and tracer_trips is not None:
            acoustic = per_step[name] - 3 * config.k_split
            expect = acoustic * steps + tracer_trips
            how = (f"{acoustic}/step x {steps} in the acoustics + "
                   f"{tracer_trips} subcycle trips")
        log(f"[{tag}] {name} launches: expected {expect} ({how}), "
            f"got {count}")
        if count != expect or count == 0:
            raise AssertionError(
                f"{name}: {count} launches, expected {expect}")


class TripCounts:
    """Stands in for tracer advection's `subcycle_count` while in use and
    keeps every trip count the dynamic subcycle took."""

    def __init__(self):
        from pace_torch.ops import tracer_advection

        self.module = tracer_advection
        self.count = tracer_advection.subcycle_count
        self.trips = []

    def __call__(self, *args):
        self.trips.append(self.count(*args))
        return self.trips[-1]

    def __enter__(self):
        self.module.subcycle_count = self
        return self

    def __exit__(self, *exc):
        self.module.subcycle_count = self.count


def run_path(tag, n, dt, warmup, timed, card, **settings) -> dict:
    """Drive DynamicalCore.step_dynamics at C`n`/79 float32 with the launch
    counts set to 0 just before and read just after; check every
    prognostic interior is finite and every kernel ran exactly as often as
    the configuration implies (under the dynamic subcycle, as often as the
    trip counts it took imply).  Returns the launch counts."""
    t0 = time.perf_counter()
    sizing, core, state = make_core(n, torch.float32, dt, **settings)
    torch.cuda.synchronize()
    label = " ".join(f"{k}={v}" for k, v in settings.items())
    log(f"[{tag}] C{n}/79 float32 {label} dt={dt:g}: set-up "
        f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    with TripCounts() as trips:
        for _ in range(warmup):
            state = core.step_dynamics(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state = core.step_dynamics(state)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = read_launches()
    check_finite(tag, state, sizing)
    if core.config.dynamic_tracer_subcycle:
        log(f"[{tag}] dynamic subcycle: n_split_dyn {trips.trips} in "
            f"{warmup + timed} steps")
        check_launches(tag, launches, core.config, warmup + timed,
                       tracer_trips=sum(trips.trips))
    else:
        check_launches(tag, launches, core.config, warmup + timed)
    log(f"[{tag}] info: {ms:.3f} ms/step, {dt / (ms / 1e3):.1f} sim-days/day "
        f"({timed} steps after {warmup} warm-up) on {card}")
    return launches


# ---------------------------------------------------------------------------
# phases 7, 7b, 8: the coupled step behind the Driver
# ---------------------------------------------------------------------------

WATER = ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel")
# examples/configs/baroclinic_c12_coupled.yaml
COUPLED = dict(dycore_config=dict(k_split=1, n_split=2, do_sat_adj=True,
                                  fv_sg_adj=3600, n_sponge=48),
               physics_config=dict(dt_atmos=225, mp_time=225))


def driver_config(n, dtype, dt, dycore_config, physics_config,
                  steps=1) -> dict:
    return dict(nx_tile=n, nz=79, dt_atmos=dt, seconds=int(steps * dt),
                dtype=dtype,
                initialization={"type": "baroclinic"},
                dycore_config=dycore_config, physics_config=physics_config)


class Tap:
    """Stands in for the physics driver's microphysics scheme and keeps the
    last state it was given and the tendencies it returned."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.state = self.out = None

    def __call__(self, state):
        self.state, self.out = state, self.scheme(state)
        return self.out


def column_water(state, sizing):
    """Per column of the compute domain, sum over k of delp * (vapour +
    condensates), float64."""
    h, n = sizing.halo, sizing.n
    q = sum(getattr(state, name).double() for name in WATER)
    return (state.delp.double() * q)[:, h:h + n, h:h + n].sum(-1)


def check_water_budget(tag, driver, before, label):
    """One physics half from `before`: the water that left the columns is
    the precipitation the microphysics reported, to float32 round-off of
    the columns' water."""
    sizing = driver.state.sizing
    h, n = sizing.halo, sizing.n
    tap = driver.physics._microphysics
    after = driver.physics_step(before)
    convt = 86400.0 / driver.config.dt_atmos / 9.80665
    precip = sum(tap.out[k].double() for k in ("rain", "snow", "ice",
                                               "graupel")) / convt
    precip = precip[:, h:h + n, h:h + n]
    w0, w1 = column_water(before, sizing), column_water(after, sizing)
    resid = float((w1 - w0 + precip).abs().max())
    scale = float(w0.abs().max())
    bar = 2e-6 * scale
    ok = resid <= bar
    log(f"[{tag}] water budget of the physics half ({label}): columns hold "
        f"up to {scale:.4e} Pa of water, precipitation up to "
        f"{float(precip.max()):.4e} Pa a step, largest |change + "
        f"precipitation| {resid:.3e} Pa (bar 2e-6 of the columns' water: "
        f"{bar:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"water budget ({label}): {resid} > {bar}")
    return after, float(precip.max())


def run_coupled(card) -> dict:
    """Phase 7.  Returns the launch counts of the timed and warm-up steps."""
    import dataclasses

    from pace_torch.driver import Driver

    t0 = time.perf_counter()
    warmup, timed = 1, 3
    driver = Driver.from_dict(
        driver_config(48, "float32", 225.0, **COUPLED, steps=timed))
    driver.physics._microphysics = Tap(driver.physics._microphysics)
    sizing = driver.state.sizing
    h, n = sizing.halo, sizing.n
    state0 = driver.state.dycore_state
    torch.cuda.synchronize()
    log(f"[7] Driver C48/79 float32 dt=225 k_split=1 n_split=2 do_sat_adj "
        f"fv_sg_adj=3600 n_sponge=48 gfdl mp_time=225: set-up "
        f"{time.perf_counter() - t0:.2f} s")

    reset_launches()
    for _ in range(warmup):
        driver.step()
    torch.cuda.synchronize()
    # the entry point's own time: step_all takes the configuration's
    # `timed` steps and ends in a synchronize
    t0 = time.perf_counter()
    driver.step_all()
    ms = (time.perf_counter() - t0) / timed * 1e3
    # the two halves, composed as Driver.step composes them, by CUDA events
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(2 * timed + 1)]
    marks[0].record()
    for i in range(timed):
        state = driver.dycore.step_dynamics(driver.state.dycore_state)
        marks[2 * i + 1].record()
        driver.state.dycore_state = driver.physics_step(state)
        marks[2 * i + 2].record()
    torch.cuda.synchronize()
    launches = read_launches()
    dyn_ms = sum(marks[2 * i].elapsed_time(marks[2 * i + 1])
                 for i in range(timed)) / timed
    phy_ms = sum(marks[2 * i + 1].elapsed_time(marks[2 * i + 2])
                 for i in range(timed)) / timed

    state = driver.state.dycore_state
    check_finite(7, state, sizing)
    pt = state.pt[:, h:h + n, h:h + n]
    delp = state.delp[:, h:h + n, h:h + n]
    lo, hi, dpmin = float(pt.min()), float(pt.max()), float(delp.min())
    ok = 150.0 < lo and hi < 350.0 and dpmin > 0.0
    log(f"[7] pt in [{lo:.2f}, {hi:.2f}] K (bar 150-350), min delp "
        f"{dpmin:.3f} Pa (bar > 0) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"coupled C48: pt [{lo}, {hi}], delp {dpmin}")
    check_launches(7, launches, driver.config.dycore_config,
                   warmup + 2 * timed)

    # the water budget, on the run's own state and from a moistened start
    # (the baroclinic wave starts below saturation and does not rain)
    check_water_budget(7, driver, driver.dycore.step_dynamics(state),
                       "the run's state")
    wet = dataclasses.replace(state0, qvapor=state0.qvapor * 1.5)
    _, rained = check_water_budget(
        7, driver, driver.dycore.step_dynamics(wet), "vapour x 1.5")
    if not rained > 0.0:
        raise AssertionError("the moistened start did not rain")
    log(f"[7] info: {ms:.3f} ms/step ({225.0 / (ms / 1e3):.1f} sim-days/day; "
        f"Driver.step_all over {timed} steps after {warmup} warm-up); in "
        f"{timed} more steps taken as two halves, dycore half {dyn_ms:.3f} "
        f"ms, physics half {phy_ms:.3f} ms (CUDA events) on {card}")
    return launches


def check_card_against_cpu():
    """Phase 7b."""
    import dataclasses

    from pace_torch.driver import Driver

    config = driver_config(12, "float64", 225.0, **COUPLED)
    card, cpu = Driver.from_dict(config), Driver.from_dict(config, "cpu")
    h, n = 3, 12
    for factor, label in ((1.0, "baroclinic"), (1.5, "vapour x 1.5")):
        outs = []
        for driver in (card, cpu):
            s0 = driver.state.dycore_state
            s0 = dataclasses.replace(s0, qvapor=s0.qvapor * factor)
            outs.append(driver.physics_step(driver.dycore.step_dynamics(s0)))
        errs = {}
        for f in dataclasses.fields(outs[0]):
            g = getattr(outs[0], f.name)[:, h:h + n, h:h + n].cpu()
            r = getattr(outs[1], f.name)[:, h:h + n, h:h + n]
            errs[f.name] = float((g - r).abs().max()) / (
                float(r.abs().max()) + 1e-30)
        worst = max(errs, key=errs.get)
        ok = errs[worst] <= 1e-9
        log(f"[7b] C12/79 float64 coupled step ({label}), card against CPU: "
            f"worst field {worst} rel err {errs[worst]:.3e} (bar 1e-9) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"card vs CPU ({label}): {worst} "
                                 f"{errs[worst]}")


EMULATOR_HIDDEN = (256, 256, 256)
EMULATOR_WEIGHTS = os.path.join(REPO, "build", "chip_smoke_emulator.npz")


def write_emulator_weights() -> str:
    """Seeded He weights of the MLP emulator, the output layer (zero when
    drawn) made small and non-zero so that the network does work, saved
    to EMULATOR_WEIGHTS."""
    from pace_torch.models.physics import emulator

    hidden = EMULATOR_HIDDEN
    params = emulator._init_params(
        emulator.MLPEmulatorConfig(hidden_sizes=hidden, seed=11), 79)
    generator = torch.Generator().manual_seed(12)
    last = f"w{len(hidden)}"
    params[last] = 0.05 * torch.randn(params[last].shape,
                                      generator=generator)
    os.makedirs(os.path.dirname(EMULATOR_WEIGHTS), exist_ok=True)
    emulator.save_params(params, EMULATOR_WEIGHTS)
    return EMULATOR_WEIGHTS


def emulator_driver_config(**extra) -> dict:
    """Phase 8's coupled step: the dycore settings of
    c384_multihost_emulator.yaml at C96/79 float32, dt 150 s, with the
    emulator's seeded weights (write_emulator_weights)."""
    return dict(driver_config(
        96, "float32", 150.0, dict(do_sat_adj=True, **SHIELD),
        dict(dt_atmos=150, mp_time=150, microphysics_scheme="emulator",
             emulator=dict(hidden_sizes=list(EMULATOR_HIDDEN),
                           weights_path=EMULATOR_WEIGHTS))), **extra)


def run_emulator(card) -> None:
    """Phase 8."""
    from pace_torch.driver import Driver
    from pace_torch.models.physics import emulator

    hidden = EMULATOR_HIDDEN
    write_emulator_weights()
    t0 = time.perf_counter()
    driver = Driver.from_dict(emulator_driver_config())
    sizing = driver.state.sizing
    torch.cuda.synchronize()
    log(f"[8] Driver C96/79 float32 dt=150 k_split=2 n_split=3 hord 8 "
        f"hord_tr 10 do_sat_adj emulator {list(hidden)} bfloat16: set-up "
        f"{time.perf_counter() - t0:.2f} s")
    warmup, timed = 1, 2
    reset_launches()
    driver.step()
    tap = Tap(driver.physics._microphysics)
    driver.physics._microphysics = tap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        driver.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = read_launches()
    check_finite(8, driver.state.dycore_state, sizing)
    check_launches(8, launches, driver.config.dycore_config, warmup + timed)

    h, n = sizing.halo, sizing.n
    total = sum(tap.out[k].double() for k in emulator.WATER_TENDENCIES)
    weighted = (total * tap.state.delp.double())[:, h:h + n, h:h + n]
    net = float(weighted.sum(-1).abs().max())
    gross = float(weighted.abs().sum(-1).max())
    moved = float(tap.out["pt_dt"].abs().max())
    ok = net <= 1e-5 * gross and gross > 0.0 and moved > 0.0
    log(f"[8] emulator water conservation: largest |column sum of delp x "
        f"water tendencies| {net:.3e} against {gross:.3e} gross (bar 1e-5), "
        f"largest |pt_dt| {moved:.3e} K/s (bar > 0) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"emulator conservation: {net} vs {gross}")
    log(f"[8] info: {ms:.3f} ms/step, {150.0 / (ms / 1e3):.1f} sim-days/day "
        f"({timed} steps after {warmup} warm-up) on {card}")


# ---------------------------------------------------------------------------
# phase 9: the yaml entry point, python -m pace_torch.driver.run
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(REPO, "examples", "configs")
# phase 9's run of c48_sections_perf.yaml, kept for phase 14
PHASE9_C48 = os.path.join(REPO, "build", "phase9_c48_sections")


def yaml_copy(name, work, profile=False, **changes) -> str:
    """A copy of examples/configs/<name> in `work` whose diagnostics and
    restart paths point into `work`, with `changes` (run length, restart
    section, start) applied and, with `profile`, a Chrome trace written to
    `work`/prof; returns its path."""
    import yaml

    with open(os.path.join(EXAMPLES, name)) as f:
        config = yaml.safe_load(f)
    config.update(changes)
    os.makedirs(work)
    if profile:
        config["performance_config"]["profile_dir"] = os.path.join(work,
                                                                   "prof")
    if config.get("diagnostics_config", {}).get("path"):
        config["diagnostics_config"]["path"] = os.path.join(work, "output")
    if "restart_config" in config:
        config["restart_config"]["path"] = os.path.join(work, "RESTART")
    path = os.path.join(work, name)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def run_cli(path, device="cuda") -> dict:
    """`pace_torch.driver.run.main` on `path` from its directory (the perf
    JSON lands there), launch counts set to 0 just before and read just
    after.  Returns the launch counts."""
    from pace_torch.driver.run import main

    here = os.getcwd()
    os.chdir(os.path.dirname(path))
    try:
        reset_launches()
        rc = main([path, "--log-level", "WARNING", "--device", device])
        launches = read_launches()
    finally:
        os.chdir(here)
    if rc != 0:
        raise AssertionError(f"{path}: exit code {rc}")
    return launches


def diagnostics_records(config) -> list:
    """Every record of the run's diagnostics as {name: array}, read back
    from their npz files or Zarr store (the formats the example
    configurations use)."""
    from pace_torch.utils.zarrlite import read_zarr_array

    diag = config.diagnostics_config
    if diag.path is None or not (diag.names or diag.derived_names):
        return []
    if diag.output_format == "zarr":
        store = os.path.join(diag.path, "state.zarr")
        arrays = {name: read_zarr_array(os.path.join(store, name))
                  for name in os.listdir(store) if name != "time"
                  and os.path.isdir(os.path.join(store, name))}
        n = len(next(iter(arrays.values())))
        return [{k: v[i] for k, v in arrays.items()} for i in range(n)]
    records = []
    for fname in sorted(os.listdir(diag.path)):
        if fname.startswith("state_"):
            with np.load(os.path.join(diag.path, fname)) as data:
                records.append({k: data[k] for k in data.files
                                if k != "time"})
    return records


def check_yaml_run(path, launches, card, sections=False, tag=9) -> dict:
    """The checks every phase-9 run passes: finite diagnostics in their
    format, a perf JSON with SYPD > 0 (and, with sections, each section's
    time > 0 and their sum within the step's), the restart where one is
    configured, the exact launch counts.  Logs ms/step, SYPD,
    sim-days/day, launches a step and the files written; returns the
    perf report."""
    from pace_torch.driver.driver import DriverConfig

    config = DriverConfig.from_yaml(path)
    name = os.path.basename(path)
    steps = config.n_timesteps()
    work = os.path.dirname(path)
    records = diagnostics_records(config)
    expect = steps // config.diagnostics_config.output_frequency + int(
        config.diagnostics_config.output_initial_state)
    if config.diagnostics_config.names and len(records) != expect:
        raise AssertionError(f"{name}: {len(records)} diagnostics records, "
                             f"expected {expect}")
    for record in records:
        for key, value in record.items():
            if not np.isfinite(value).all():
                raise AssertionError(f"{name}: diagnostic {key} not finite")
    with open(os.path.join(
            work, f"{config.performance_config.experiment_name}_perf.json")
            ) as f:
        report = json.load(f)
    times = report["times_per_step"]
    if len(times) != steps or not report["sypd"] > 0.0:
        raise AssertionError(f"{name}: {len(times)} steps timed, SYPD "
                             f"{report['sypd']}")
    if sections:
        keys = ["DynCore", "TracerAdvection", "Remapping"]
        if not config.dycore_only:
            keys.append("Physics")
        for t in times:
            parts = [t.get(k, 0.0) for k in keys]
            if min(parts) <= 0.0 or sum(parts) > t["mainloop"]:
                raise AssertionError(f"{name}: sections {t}")
        share = sum(sum(t[k] for k in keys) for t in times[1:]) / sum(
            t["mainloop"] for t in times[1:])
        log(f"[{tag}] {name}: sections "
            + ", ".join(f"{k} {np.mean([t[k] for t in times[1:]]) * 1e3:.3f}"
                        for k in keys)
            + f" ms/step, {share:.4f} of mainloop")
    if config.restart_config.save_restart:
        from pace_torch.driver.restart import load_restart_arrays

        arrays = load_restart_arrays(config.restart_config.path)
        if len(arrays) != 32:
            raise AssertionError(f"{name}: restart holds {len(arrays)}")
    check_launches(tag, launches, config.dycore_config, steps)
    ms = float(np.mean([t["mainloop"] for t in times[1:]])) * 1e3
    files = [os.path.relpath(os.path.join(d, f), work)
             for d, _, fs in os.walk(work) for f in fs]
    nbytes = sum(os.path.getsize(os.path.join(work, f)) for f in files)
    tops = sorted({f.split(os.sep)[0] + ("/" if os.sep in f else "")
                   for f in files})
    log(f"[{tag}] {name}: {steps} steps, {ms:.3f} ms/step (mainloop without "
        f"step 1), SYPD {report['sypd']:.4f}, "
        f"{config.dt_atmos / (ms / 1e3):.1f} sim-days/day, launches a step "
        + "/".join(str(launches[k] // steps) for k in ("K-T", "K-S", "K-F"))
        + f", initialization {report['total_times']['initialization']:.2f} "
        f"s, "
        + (f"safety checks every {config.safety_check_frequency} steps "
           "passed" if config.safety_check_frequency else "no safety checks")
        + f"; wrote {len(files)} files, {nbytes / 1e6:.1f} MB: "
        + ", ".join(tops) + f" on {card}")
    return report


KERNEL_SYMBOLS = {"K-T": "transport_kernel", "K-S": "sim1_kernel",
                  "K-F": "fillz_kernel"}


def check_trace(path, launches) -> None:
    """The run's Chrome trace (performance_config.profile_dir) holds one
    device kernel event per launch of each hand-written kernel."""
    from pace_torch.driver.driver import DriverConfig

    config = DriverConfig.from_yaml(path)
    trace = os.path.join(config.performance_config.profile_dir, "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sum(symbol in e.get("name", "") for e in kernels)
             for k, symbol in KERNEL_SYMBOLS.items()}
    busy = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    ok = found == launches
    log(f"[9] profile_dir: {os.path.getsize(trace) / 1e6:.1f} MB Chrome "
        f"trace of {config.n_timesteps()} step(s), {len(kernels)} device "
        f"kernel events ({busy:.3f} ms busy), of them K-T/K-S/K-F "
        + "/".join(str(found[k]) for k in KERNEL_SYMBOLS)
        + " (launches counted " + "/".join(str(launches[k])
                                            for k in KERNEL_SYMBOLS)
        + f") {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"trace kernels {found} != launches {launches}")
    check_launches(9, launches, config.dycore_config, config.n_timesteps())


def interior_error(got: dict, ref: dict, n: int, h: int = 3) -> tuple:
    """(worst field, its largest |got - ref| over the compute domain
    relative to the field's scale there)."""
    errs = {}
    for name, r in ref.items():
        g, r = got[name], r
        if r.ndim >= 3:
            g, r = g[:, h:h + n, h:h + n], r[:, h:h + n, h:h + n]
        errs[name] = float(np.abs(g.astype(np.float64) - r).max()) / (
            float(np.abs(r).max()) + 1e-30)
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def vortex(ps, pt, lon, lat, area) -> tuple:
    """(the minimum's distance from the vortex centre (180E, 10N) in m, the
    width of its cell in m, pt at level 60 there, the median pt at level
    60) over compute-domain arrays."""
    from pace_torch.models.fv3.init.tropical_cyclone import TC

    lon0, lat0 = np.deg2rad(TC["lon_tc"]), np.deg2rad(TC["lat_tc"])
    dist = 6.3712e6 * np.arccos(np.clip(
        np.sin(lat) * np.sin(lat0)
        + np.cos(lat) * np.cos(lat0) * np.cos(lon - lon0), -1.0, 1.0))
    at = np.unravel_index(np.argmin(ps), ps.shape)
    return (float(dist[at]), float(np.sqrt(area[at])),
            float(pt[at + (60,)]), float(np.median(pt[..., 60])))


def check_tc_vortex(path) -> None:
    """The checks of tests/test_tropical_cyclone.py on the start the run
    takes (init_tc_state on the card, C48/79 float32): a dp-deep
    surface-pressure minimum, p_ref far away, a warm core at level 60;
    then on the run's last diagnostics: the minimum still in the cell
    nearest the vortex centre (or a neighbour), at least dp / 4 below the
    median surface pressure, over a warm core."""
    from pace_torch.driver.driver import DriverConfig
    from pace_torch.models.fv3.init.tropical_cyclone import TC, init_tc_state
    from pace_torch.utils.gridtools import GridSizing

    config = DriverConfig.from_yaml(path)
    n, h = config.nx_tile, 3
    c = (slice(None), slice(h, h + n), slice(h, h + n))
    with np.load(os.path.join(config.diagnostics_config.path,
                              "grid.npz")) as grid:
        lon, lat, area = (grid[k][c] for k in ("lon_agrid", "lat_agrid",
                                                "area"))
    start = init_tc_state(GridSizing(n, config.nz))
    ps0, pt0 = start.ps[c].cpu().numpy(), start.pt[c].cpu().numpy()
    last = diagnostics_records(config)[-1]
    ps, pt = last["ps"], last["pt"]
    lo, hi = TC["p_ref"] - TC["dp"] - 50.0, TC["p_ref"] - 500.0
    d0, cell0, core0, far0 = vortex(ps0, pt0, lon, lat, area)
    d1, cell1, core1, far1 = vortex(ps, pt, lon, lat, area)
    dip, bar = float(np.median(ps) - ps.min()), TC["dp"] / 4
    ok0 = (lo < ps0.min() < hi and abs(ps0.max() - TC["p_ref"]) < 50.0
           and d0 < 1.5 * cell0 and core0 > far0)
    ok1 = d1 < 1.5 * cell1 and dip > bar and core1 > far1
    log(f"[9] tropical cyclone start: ps {ps0.min():.2f}-{ps0.max():.2f} Pa "
        f"(bars {lo:g}-{hi:g} and p_ref +-50), minimum {d0 / 1e3:.1f} km "
        f"from the centre (bar 1.5 cells = {1.5 * cell0 / 1e3:.1f} km), pt "
        f"at level 60 {core0:.3f} K in the core against {far0:.3f} K "
        f"median {'ok' if ok0 else 'FAIL'}")
    log(f"[9] tropical cyclone after {config.n_timesteps()} steps: ps "
        f"{ps.min():.2f}-{ps.max():.2f} Pa, minimum {dip:.2f} Pa below the "
        f"median (bar dp / 4 = {bar:g}) and {d1 / 1e3:.1f} km from the "
        f"centre (bar {1.5 * cell1 / 1e3:.1f} km), pt at level 60 "
        f"{core1:.3f} K in the "
        f"core against {far1:.3f} K median {'ok' if ok1 else 'FAIL'}")
    if not (ok0 and ok1):
        raise AssertionError("tropical cyclone structure")


def run_yaml_configs(card) -> dict:
    """Phase 9.  Returns each kernel's launches summed over the runs on the
    card."""
    import tempfile

    from pace_torch.driver.driver import Driver, DriverConfig
    from pace_torch.driver.restart import load_restart_arrays

    total = dict.fromkeys(("K-T", "K-S", "K-F"), 0)

    def on_card(path) -> dict:
        launches = run_cli(path)
        for k in total:
            total[k] += launches[k]
        return launches

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        # baroclinic_c12.yaml, whole (4 steps), on the card and the CPU
        t0 = time.perf_counter()
        paths = {dev: yaml_copy("baroclinic_c12.yaml",
                                os.path.join(tmp, f"c12_{dev}"))
                 for dev in ("cuda", "cpu")}
        launches = on_card(paths["cuda"])
        check_yaml_run(paths["cuda"], launches, card)
        run_cli(paths["cpu"], device="cpu")
        worst, err = interior_error(
            *(load_restart_arrays(os.path.join(tmp, f"c12_{dev}", "RESTART"))
              for dev in ("cuda", "cpu")), n=12)
        log(f"[9] baroclinic_c12.yaml restart, card against CPU: worst "
            f"field {worst} rel err {err:.3e} (bar 1e-9) "
            f"{'ok' if err <= 1e-9 else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s both runs)")
        if not err <= 1e-9:
            raise AssertionError(f"c12 card vs CPU: {worst} {err}")

        # the same yaml for one step with profile_dir: a Chrome trace
        path = yaml_copy("baroclinic_c12.yaml",
                         os.path.join(tmp, "c12_profiled"), profile=True,
                         minutes=0, seconds=225)
        check_trace(path, on_card(path))

        # baroclinic_c12_coupled.yaml, whole (8 steps)
        path = yaml_copy("baroclinic_c12_coupled.yaml",
                         os.path.join(tmp, "c12_coupled"))
        check_yaml_run(path, on_card(path), card)

        # c48_sections_perf.yaml (6 steps) with a restart at step 3; then
        # 3 steps from that restart reach the same final state
        restart = dict(save_restart=True, intermediate_restart=[3])
        path = yaml_copy("c48_sections_perf.yaml",
                         os.path.join(tmp, "c48_sections"),
                         restart_config=restart)
        check_yaml_run(path, on_card(path), card, sections=True)
        first = os.path.join(tmp, "c48_sections", "RESTART")
        with open(os.path.join(first, "step_000003", "time.json")) as f:
            start = json.load(f)["time"]
        again = yaml_copy(
            "c48_sections_perf.yaml", os.path.join(tmp, "c48_restarted"),
            restart_config=dict(save_restart=True), minutes=0, seconds=1350,
            initialization=dict(type="restart", config=dict(
                path=os.path.join(first, "step_000003"),
                start_time_str=start)))
        check_yaml_run(again, on_card(again), card, sections=True)
        a = load_restart_arrays(first)
        b = load_restart_arrays(os.path.join(tmp, "c48_restarted",
                                             "RESTART"))
        same = sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            for k in a)
        log(f"[9] c48_sections_perf.yaml: 3 steps from the step-3 restart "
            f"against the 6-step run's final restart, {len(a)} fields "
            f"element by element: {'identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("restart round trip differs")
        # phase 14 runs the same yaml over six ranks against these files
        import shutil

        shutil.rmtree(PHASE9_C48, ignore_errors=True)
        shutil.copytree(os.path.join(tmp, "c48_sections"), PHASE9_C48)

        # c96_baroclinic_shield.yaml, whole (6 steps)
        path = yaml_copy("c96_baroclinic_shield.yaml",
                         os.path.join(tmp, "c96_shield"))
        check_yaml_run(path, on_card(path), card)

        # tropical_cyclone_c48.yaml, cut from 1 hour to 15 minutes (4 steps)
        path = yaml_copy("tropical_cyclone_c48.yaml", os.path.join(tmp, "tc"),
                         hours=0, minutes=15)
        check_yaml_run(path, on_card(path), card)
        check_tc_vortex(path)

        # c384_multihost_emulator.yaml: its 96-rank mesh
        report_c384_mesh(os.path.join(tmp, "c384_halo"))

    return total


def report_c384_mesh(work) -> None:
    """c384_multihost_emulator.yaml hydrates, and its [6, 4, 4] mesh (hosts
    [6, 1, 1]) builds at n = 384 without a process group: the ranks' box
    sizes and rank 0's exchange plans, rows received per halo kind, and
    the bytes rank 0 receives a step.  A step's halo calls are those of
    the yaml's own step, recorded on one process at C12 (`Driver.step()`
    of the yaml with nx_tile 12 and one rank), each call's bytes the
    plan's rows times the call's values a point at 4 bytes (float32)."""
    from pace_torch.driver import Driver, DriverConfig
    from pace_torch.parallel.halo import RankTopology
    from pace_torch.parallel.partition import Partition
    from pace_torch.parallel.traffic import HaloTrafficRecorder

    path = os.path.join(EXAMPLES, "c384_multihost_emulator.yaml")
    config = DriverConfig.from_yaml(path)
    t0 = time.perf_counter()
    partition = Partition(config.mesh.layout, config.nx_tile,
                          dcn_mesh_shape=config.mesh.dcn_mesh_shape)
    sizes = set()
    for rank in range(partition.size):
        si, sj = partition.domain(rank).compute()
        sizes.add((si.stop - si.start, sj.stop - sj.start))
    if partition.size != 96 or sizes != {(96, 96)}:
        raise AssertionError(f"c384 mesh: {partition.size} ranks, boxes "
                             f"{sizes}")
    topo = RankTopology(partition, 0, None)
    # the halo calls of one step of the yaml, recorded at C12 on one rank
    small = yaml_copy("c384_multihost_emulator.yaml", work, nx_tile=12,
                      mesh=dict(layout=[1, 1, 1]))
    driver = Driver(DriverConfig.from_yaml(small))
    recorder = HaloTrafficRecorder.recording()
    with recorder:
        driver.step()
    plans = {}
    received = 0
    N = 12 + 6 + 6  # the C12 storage extent
    for kind, lead, result in recorder.calls:
        head, rest = kind.split(":", 1)
        if head in ("vector1", "ifsync1") or kind.endswith("+corner_x"):
            continue  # the second output of a call counted with the first
        if head == "scalar":
            plan = (topo.scalar_corner_specs()
                    if rest.startswith("center+corner")
                    else topo.scalar_spec(rest))
        elif head == "vector0":
            plan = topo.vector_spec(*rest.split(":"))
        else:
            plan = topo.interface_sync_map(*rest.split(":"))
        width = result.size // (6 * N * N)
        entry = plans.setdefault(plan.kind, [plan.recv_rows, 0, 0])
        entry[1] += 1
        entry[2] += plan.recv_rows * width * 4
        received += plan.recv_rows * width * 4
    log(f"[9] c384_multihost_emulator.yaml hydrates; its mesh "
        f"{list(config.mesh.layout)} (hosts "
        f"{list(config.mesh.dcn_mesh_shape)}) builds at n=384 without a "
        f"process group: {partition.size} ranks, every box "
        f"{sizes.pop()} compute cells, rank 0 holds "
        f"{partition.local_box(0).shape} points")
    for kind, (rows, calls, nbytes) in sorted(plans.items()):
        log(f"[9] c384 rank 0 plan {kind}: {rows} rows received a call, "
            f"{calls} calls a step, {nbytes / 1e6:.3f} MB a step")
    log(f"[9] c384 rank 0 receives {received / 1e6:.3f} MB a step in "
        f"{sum(c for _, c, _ in plans.values())} exchanges (float32; "
        f"{time.perf_counter() - t0:.1f} s)")

# ---------------------------------------------------------------------------
# phase 10: the dycore branches
# ---------------------------------------------------------------------------

BRANCHES = {
    "kord 8": dict(kord_mt=8, kord_wz=8, kord_tr=8, kord_tm=-8),
    "kord 10": dict(kord_mt=10, kord_wz=10, kord_tr=10, kord_tm=-10),
    "do_skeb": dict(do_skeb=True),
    "dynamic subcycle": dict(dynamic_tracer_subcycle=True),
}


def state_arrays(state) -> dict:
    import dataclasses

    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


# the field each remap mode iv is given in tests/test_torch_branches.py
FIELD_OF_MODE = {-2: "w", -1: "u", 0: "qvapor", 1: "delz", 2: "pt"}


def check_kord10_columns(arrays, core) -> None:
    """remap_profile and map_single at kord 10, every remap mode, on the
    card and on the CPU from the same columns (the compute domain of a
    kord-10 step's output): every coefficient and remapped value within
    1e-9 of the field's scale."""
    from pace_torch.ops.map_single import map_single
    from pace_torch.ops.remap_profile import remap_profile

    c = (slice(None), slice(3, 15), slice(3, 15))
    ak = core.grid_data.vertical.ak.cpu().numpy()
    bk = core.grid_data.vertical.bk.cpu().numpy()
    pe1 = arrays["pe"][c]
    pe2 = np.concatenate(
        [pe1[..., :1], ak[1:79] + bk[1:79] * pe1[..., -1:], pe1[..., -1:]],
        -1)
    worst = 0.0
    for iv, name in FIELD_OF_MODE.items():
        q = arrays[name][c]
        qs = arrays["w"][c][..., -1] if iv == -2 else np.zeros(q.shape[:-1])
        outs = []
        for device in ("cuda", "cpu"):
            t = on((qs, q, pe1[..., 1:] - pe1[..., :-1], pe1, pe2),
                   torch.float64, device)
            outs.append([*remap_profile(t[0], t[1], t[2], 12, 3, 10, iv),
                         map_single(t[1], t[3], t[4], 12, 3, 10, iv,
                                    qs=t[0])])
        scale = float(np.abs(q).max())
        err = max(float((g.cpu() - r).abs().max()) for g, r in zip(*outs))
        worst = max(worst, err / scale)
    ok = worst <= 1e-9
    log(f"[10] kord 10 remap_profile and map_single, iv -2..2, on the same "
        f"columns on the card and the CPU: worst rel err {worst:.3e} (bar "
        f"1e-9) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kord 10 columns: {worst}")


def run_branches(card) -> dict:
    """Phase 10.  Returns the launch counts of the dynamic subcycle's C48
    steps."""
    for label, settings in BRANCHES.items():
        t0 = time.perf_counter()
        outs = []
        for device in ("cuda", "cpu"):
            _, core, state = make_core(12, torch.float64, 225.0, device,
                                       **settings)
            outs.append(state_arrays(core.step_dynamics(state)))
        worst, err = interior_error(*outs, n=12)
        if label == "kord 10":
            # kord 10 branches on |2 a1 - (a2 + a3)| > |a2 - a3|, an exact
            # tie wherever the monotonicity clamp set an interface to its
            # cell's mean.  The card's exp, log and cumsum round otherwise
            # than the CPU's in the last place, so at some ties the two
            # steps take different branches: the step is reported, and the
            # kord-10 operators are held on identical columns.
            pt = [o["pt"][:, 3:15, 3:15] for o in outs]
            moved = int((np.abs(pt[0] - pt[1]).max(-1)
                         > 1e-9 * np.abs(pt[1]).max()).sum())
            log(f"[10] C12/79 float64 kord 10: card against CPU, worst field "
                f"{worst} rel err {err:.3e}; pt differs by more than 1e-9 "
                f"of its scale in {moved} of {pt[1][..., 0].size} columns "
                f"({time.perf_counter() - t0:.1f} s both steps)")
            check_kord10_columns(outs[0], core)
        else:
            ok = err <= 1e-9
            log(f"[10] C12/79 float64 {label}: card against CPU, worst field "
                f"{worst} rel err {err:.3e} (bar 1e-9) "
                f"{'ok' if ok else 'FAIL'} "
                f"({time.perf_counter() - t0:.1f} s both steps)")
            if not ok:
                raise AssertionError(f"{label}: card vs CPU {worst} {err}")
        if settings.get("do_skeb"):
            diss = outs[0]["diss_estd"][:, 3:15, 3:15]
            ok = bool(np.isfinite(diss).all()) and float(
                np.abs(diss).max()) > 0.0
            log(f"[10] do_skeb: diss_estd on the compute domain finite, "
                f"largest |value| {float(np.abs(diss).max()):.4e} (bar > 0) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("do_skeb: diss_estd")
        launches = run_path(10, 48, 450.0, 1, 1, card, k_split=1, n_split=2,
                            **settings)
        if settings.get("dynamic_tracer_subcycle"):
            subcycle = launches
    return subcycle


# ---------------------------------------------------------------------------
# phase 11: the JW day-1 anchor
# ---------------------------------------------------------------------------

def check_jw_day1() -> None:
    from pace_torch.validation import jw_day1

    with open(os.path.join(REPO, "tests", "golden",
                           "jw_day1_c12_f64.json")) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    got = jw_day1.run_day1("cuda", torch.float64)
    wall = time.perf_counter() - t0
    worst, bad = jw_day1.check(record["digest"], got)
    field = max(worst, key=worst.get)
    log(f"[11] JW day 1, C12/79 float64 k_split=1 n_split=4 dt=450, "
        f"{jw_day1.STEPS} steps on the card in {wall:.1f} s: worst relative "
        f"difference from the record {worst[field]:.3e} ({field}; bar "
        f"{jw_day1.RTOL:g}); per entry "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" {'FAIL' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"JW day 1: {bad} above {jw_day1.RTOL}")


# ---------------------------------------------------------------------------
# phase 12: the Fortran restart start, the GEOS wrapper, the savepoints
# ---------------------------------------------------------------------------

# restart variable -> its file, as the Fortran model writes them
RESTART_FILE = {"u": "fv_core.res", "v": "fv_core.res", "W": "fv_core.res",
                "DZ": "fv_core.res", "T": "fv_core.res",
                "delp": "fv_core.res", "phis": "fv_core.res",
                "ua": "fv_core.res", "va": "fv_core.res"}


def write_fortran_restart(dirname, arrays, n, h=3) -> None:
    """The Fortran model's restart files for the state `arrays` (numpy,
    the port's padded layout): fv_core.res and fv_tracer.res for each of
    the six tiles, each variable (Time, z, y, x) or (Time, y, x), and
    coupler.res."""
    from scipy.io import netcdf_file

    from pace_torch.utils.legacy_restart import RESTART_TO_FIELD

    for tile in range(6):
        files = {}
        for name, (field, (ex, ey)) in RESTART_TO_FIELD.items():
            if field not in arrays:
                continue
            a = arrays[field][tile, h:h + n + ex, h:h + n + ey]
            if a.ndim == 3:
                data = np.transpose(a, (2, 1, 0))[None]
                dims = ("Time", "zaxis_1", f"yaxis_{1 + ey}",
                        f"xaxis_{1 + ex}")
            else:
                data, dims = a.T[None], ("Time", "yaxis_1", "xaxis_1")
            files.setdefault(RESTART_FILE.get(name, "fv_tracer.res"),
                             {})[name] = (dims, data)
        for fname, variables in files.items():
            path = os.path.join(dirname, f"{fname}.tile{tile + 1}.nc")
            with netcdf_file(path, "w") as nc:
                for name, (dims, data) in variables.items():
                    for d, size in zip(dims, data.shape):
                        if d not in nc.dimensions:
                            nc.createDimension(d, size)
                    nc.createVariable(name, "d", dims)[:] = data
    with open(os.path.join(dirname, "coupler.res"), "w") as f:
        f.write("     2        (Calendar: gregorian=3)\n"
                "  2000     1     1     0     0     0        Model start "
                "time\n"
                "  2000     1     1     0     0     0        Current model "
                "time\n")


# tests/test_geos_wrapper.py's namelist
GEOS_NML = {"fv_core_nml": {"npx": 13, "npy": 13, "npz": 79,
                            "do_sat_adj": False, "dt_atmos": 225}}
# the reference's savepoints of a k_split = n_split = 1 step, in order
SAVEPOINTS = [
    "FVDynamics-In", "C_SW-In", "C_SW-Out", "D_SW-In", "D_SW-Out",
    "Tracer2D1L-In", "Tracer2D1L-Out", "Remapping-In", "Remapping-Out",
    "FVDynamics-Out",
]


def run_entry_points(card) -> None:
    """Phase 12."""
    import tempfile

    from pace_torch.driver.driver import DriverConfig
    from pace_torch.driver.restart import load_restart_arrays
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.geos_wrapper import (
        _IN_FIELDS,
        GeosDycoreWrapper,
    )
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.models.fv3.state import TRACER_NAMES, DycoreState
    from pace_torch.utils.checkpointer import (
        SnapshotCheckpointer,
        checkpointing,
    )
    from pace_torch.utils.gridtools import GridSizing

    n, h = 12, 3
    sizing = GridSizing(n, 79)
    start = state_arrays(init_baroclinic_state(sizing, device="cpu",
                                               dtype=torch.float64))
    c = (slice(None), slice(h, h + n), slice(h, h + n))

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        restart = os.path.join(tmp, "fortran_restart")
        os.makedirs(restart)
        write_fortran_restart(restart, start, n)
        path = yaml_copy(
            "baroclinic_c12.yaml", os.path.join(tmp, "from_fortran"),
            minutes=0, seconds=450,
            initialization=dict(type="fortran_restart",
                                config=dict(path=restart)))
        launches = run_cli(path)
        check_yaml_run(path, launches, card, tag=12)
        config = DriverConfig.from_yaml(path)
        first = diagnostics_records(config)[0]
        same = all(np.array_equal(first[k], start[k][c])
                   for k in ("pt", "ua", "va"))
        final = load_restart_arrays(config.restart_config.path)
        finite = all(np.isfinite(final[k][c]).all()
                     for k in ("pt", "delp", "u", "v", "w", "ps", "qvapor"))
        log(f"[12] fortran_restart start of baroclinic_c12.yaml from "
            f"{len(os.listdir(restart))} files written with scipy: the first "
            f"diagnostics (pt, ua, va) equal the written state: {same}; "
            f"after {config.n_timesteps()} steps the restart's interiors "
            f"are finite: {finite} "
            f"({time.perf_counter() - t0:.1f} s) "
            f"{'ok' if same and finite else 'FAIL'}")
        if not (same and finite):
            raise AssertionError("fortran_restart start")

    wrapper = GeosDycoreWrapper(GEOS_NML, dtype=torch.float64)
    fields = {name: start[name] for name in _IN_FIELDS}
    q = np.stack([start[name] for name in TRACER_NAMES], -1)
    out = wrapper(q, **fields)
    core = DynamicalCore(wrapper.dycore_config, sizing,
                         wrapper.dycore.grid_data, 225.0)
    want = state_arrays(core.step_dynamics(
        DycoreState.from_numpy(start, "cuda", torch.float64)))
    differ = [k for k in _IN_FIELDS if not np.array_equal(
        out[k], want[k], equal_nan=True)]
    differ += [k for i, k in enumerate(TRACER_NAMES) if not np.array_equal(
        out["q"][..., i], want[k], equal_nan=True)]
    times = wrapper.perf_collector.timestep_timer.times
    log(f"[12] GeosDycoreWrapper C12/79 float64 on the card: "
        f"{len(_IN_FIELDS) + len(TRACER_NAMES)} outputs against a "
        f"DynamicalCore step on the same inputs, fields that differ: "
        f"{differ or 'none'}; "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
        + f" {'ok' if not differ else 'FAIL'}")
    if differ:
        raise AssertionError(f"GEOS wrapper differs in {differ}")

    class Order(SnapshotCheckpointer):
        def __init__(self):
            super().__init__()
            self.names = []

        def __call__(self, savepoint_name, **kwargs):
            self.names.append(savepoint_name)
            super().__call__(savepoint_name, **kwargs)

    order = Order()
    with checkpointing(order):
        core.step_dynamics(DycoreState.from_numpy(start, "cuda",
                                                  torch.float64))
    ok = order.names == SAVEPOINTS
    shapes = {v[0].shape for calls in order.data.values()
              for v in calls.values()}
    log(f"[12] one C12 step under a SnapshotCheckpointer on the card: "
        f"savepoints {order.names} (the reference's order: {ok}), arrays "
        f"cut to {sorted(shapes)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"savepoints {order.names}")


# ---------------------------------------------------------------------------
# phase 13: the savepoint harness, driver.tools and the native restart writer
# ---------------------------------------------------------------------------

# The cases the card computes with last-place differences from the CPU on
# identical inputs (the device's exp/log/pow and summation order; the SIM1
# solves and the acoustic step amplify them) that the harness's per-point
# relative metric magnifies where an output is near zero, or lies in halo
# cells no operator defines (values computed from the zero-filled cells
# outside the blocks): on the card each is held instead, output by output,
# at this bar of max |card - CPU| over its compute-domain scale
# (`TranslateCase.domain_errors`), about ten times what the card measured
# (in brackets: C12, 6 ranks; C48, 54 ranks).  Phase 13 prints beside each
# the per-point metric and what the same operator moves by on the CPU
# when its inputs are moved by 1e-15 relative (PERF.md section 6).
CARD_BOUNDS = {
    "A2B_Ord4": 3e-15,                # vort 2.388e-16
    "AtmosPhysDriverStatein": 5e-14,  # prsl 4.227e-15
    "UpdateDWindsPhys": 2e-15,        # v 1.017e-16
    "FVUpdatePhys": 2e-13,            # va 1.647e-14
    "Riem_Solver_C": 2e-14,           # gz 1.160e-15, C48 1.546e-15
    "Riem_Solver3": 2e-13,            # ppe 1.578e-14, C48 1.851e-14
    "SatAdjust3d": 2e-12,             # qliquid 1.755e-13
    "DynCore": 2e-10,                 # wsd 1.793e-11
    # the whole steps (w 1.012e-12), at the whole-step gate of phases 7b
    # and 10
    "FVDynamics": 1e-9,
    "Driver": 1e-9,
}


def nudged_inputs(case, dataset, scale=1e-15):
    """The savepoint's assembled inputs with their arrays moved by `scale`
    relative (utils.testing.perturb; scalars and per-level columns kept)."""
    from pace_torch.utils.testing import perturb

    inputs = case.assemble([dataset.inputs(r) for r in range(case.n_ranks)])
    arrays = {k: v for k, v in inputs.items()
              if np.ndim(v) and not case.in_vars[k].column}
    return {**inputs, **perturb(arrays, scale=scale)}


# the cases whose operators run a hand-written kernel on the card
KERNEL_CASES = ("FvTp2d", "Tracer2D1L", "Riem_Solver_C", "Riem_Solver3",
                "Fillz", "Remapping")


def case_savepoints(names, n, layout) -> dict:
    """Each case of `names` at C`n`/79 float64 with `layout` ranks a tile:
    its `make_inputs` on the port's baroclinic state and one step of it
    (taken on the card), its outputs computed on the CPU and written as a
    savepoint pair by the port's `write_savepoint`, then read, assembled,
    computed on the card and validated by the same case built for the card
    at its own max_error (or, for a CARD_BOUNDS case, held at its bar on
    the compute domain).  Returns the kernels' launches of the card's
    runs."""
    import tempfile

    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.utils.translate import (
        SavepointDataset,
        write_case_savepoint,
    )
    from pace_torch.utils.translate_cases import CASES
    from pace_torch.utils.translate_cases import state_arrays as case_state

    sizing, core, state = make_core(n, torch.float64, 225.0)
    s0, s1 = case_state(state), case_state(core.step_dynamics(state))
    gd_cpu = generate_grid_data(n, 79, device="cpu", dtype=torch.float64)
    ranks = 6 * layout[0] * layout[1]
    cpu_s = card_s = 0.0
    reset_launches()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for name in names:
            t0 = time.perf_counter()
            cpu_case = CASES[name](sizing, gd_cpu, layout=layout,
                                   device="cpu")
            write_case_savepoint(
                cpu_case, cpu_case.make_inputs(s0, s1, gd_cpu), tmp)
            t1 = time.perf_counter()
            case = CASES[name](sizing, core.grid_data, layout=layout)
            dataset = SavepointDataset(tmp, name)
            bar = CARD_BOUNDS.get(name)
            how = ""
            if bar is None:
                errors = case.validate(dataset)
                how = f"max_error {case.max_error:g}"
            else:
                errors, metric = case.domain_errors(dataset)
                worst = max(metric, key=metric.get)
                nudged, nudged_metric = cpu_case.domain_errors(
                    dataset, nudged_inputs(cpu_case, dataset))
                nudge = max(nudged, key=nudged.get)
                how = (f"of scale on the compute domain, bar {bar:g}; the "
                       f"per-point metric {worst} {metric[worst]:.3e}, "
                       f"max_error {case.max_error:g}; the CPU on its "
                       f"inputs moved by 1e-15: {nudge} {nudged[nudge]:.3e}"
                       f" of scale, metric "
                       f"{max(nudged_metric.values()):.3e}")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cpu_s, card_s = cpu_s + t1 - t0, card_s + t2 - t1
            worst = max(errors, key=errors.get)
            ok = bar is None or errors[worst] <= bar
            log(f"[13] C{n}/79 f64 {ranks} ranks {name}: worst {worst} "
                f"{errors[worst]:.3e} ({how}) {'ok' if ok else 'FAIL'} "
                f"(CPU {t1 - t0:.2f} s, card {t2 - t1:.2f} s)")
            if not ok:
                raise AssertionError(f"{name}: {worst} {errors[worst]} > "
                                     f"{bar}")
    launches = read_launches()
    log(f"[13] C{n} {ranks} ranks: {len(names)} cases validated on the card "
        f"against the CPU's savepoints (CPU {cpu_s:.1f} s, card "
        f"{card_s:.1f} s); kernel launches on the card: "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"phase 13: {name} was not launched")
    return launches


def run_tools(path, action, device="cuda") -> dict:
    """`python -m pace_torch.driver.tools <action> <path> --device
    <device>` in a fresh interpreter, from the yaml's directory; returns
    the report its last line prints."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pace_torch.driver.tools", action, path,
         "--device", device], cwd=os.path.dirname(path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"tools {action} {device}: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[13] tools {action} {os.path.basename(path)} --device {device} "
        f"({time.perf_counter() - t0:.1f} s): "
        + json.dumps({k: v for k, v in report.items() if k != "ops"}))
    return report


def check_tools(card) -> None:
    """`driver.tools memory` and `cost` on a copy of c48_sections_perf.yaml
    (output paths changed): the argument and output bytes are the state's,
    the step's temporary memory positive, the kernel counts those of a
    step of the configuration; and `cost` of baroclinic_c12.yaml equal on
    the card and the CPU."""
    import tempfile

    from pace_torch.driver.driver import DriverConfig
    from pace_torch.models.fv3.state import zeros_numpy
    from pace_torch.utils.gridtools import GridSizing

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = yaml_copy("c48_sections_perf.yaml", os.path.join(tmp, "c48"))
        config = DriverConfig.from_yaml(path)
        itemsize = np.dtype(config.dtype).itemsize
        state_bytes = itemsize * sum(
            a.size for a in zeros_numpy(GridSizing(config.nx_tile,
                                                   config.nz)).values())
        mem = run_tools(path, "memory")
        ok = (mem["argument_size_in_bytes"] == state_bytes
              == mem["output_size_in_bytes"]
              and mem["peak_size_in_bytes"] > mem["temp_size_in_bytes"] > 0
              and mem["generated_code_size_in_bytes"] > 0)
        log(f"[13] memory: state {state_bytes} bytes, temp "
            f"{mem['temp_size_in_bytes']} bytes (peak over the step less "
            f"the bytes allocated before it), peak "
            f"{mem['peak_size_in_bytes']} bytes on {card} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"tools memory: {mem}")
        cost = run_tools(path, "cost")
        counts = {k: v["launches"] for k, v in cost["kernels"].items()}
        expect = expected_launches(config.dycore_config)
        ok = counts == expect
        log(f"[13] cost: {cost['launches']} launches, "
            f"{cost['bytes accessed']} bytes, {cost['flops']} flops a step, "
            f"optimal {cost['optimal_seconds'] * 1e3:.3f} ms; kernels "
            f"{counts}, a step of phase 9's run launches {expect} "
            f"{'ok' if ok else 'FAIL'} on {card}")
        if not ok:
            raise AssertionError(f"tools cost kernels {counts} != {expect}")
        path = yaml_copy("baroclinic_c12.yaml", os.path.join(tmp, "c12"))
        on_card, on_cpu = (run_tools(path, "cost", device)
                           for device in ("cuda", "cpu"))
        same = ({k: v for k, v in on_card.items() if k != "device"}
                == {k: v for k, v in on_cpu.items() if k != "device"})
        log(f"[13] cost of baroclinic_c12.yaml on the card and on the CPU: "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"cost differs: card {on_card}, cpu "
                                 f"{on_cpu}")


def check_fastpack(card) -> None:
    """The native restart writer: built, a restart written through
    `driver.restart` reads back equal, and one C48/79 float32 restart
    (the state of c48_sections_perf.yaml) written through fastpack and
    through numpy.save in turns, timed; the files of both are equal."""
    import dataclasses
    import tempfile

    from pace_torch._native import fastpack
    from pace_torch.driver.restart import load_restart_arrays, write_restart
    from pace_torch.utils.host import to_host

    t0 = time.perf_counter()
    lib = fastpack.build()
    log(f"[13] fastpack: {os.path.relpath(lib, REPO)} "
        f"({time.perf_counter() - t0:.2f} s, built or found); phase 9's "
        f"step-3 restart above was written through it")
    _, _, state = make_core(48, torch.float32, 450.0)
    arrays = to_host({f.name: getattr(state, f.name)
                      for f in dataclasses.fields(state)})
    nbytes = sum(a.nbytes for a in arrays.values())

    def with_numpy(directory, arrays):
        os.makedirs(directory)
        for name, arr in arrays.items():
            np.save(os.path.join(directory, name + ".npy"), arr)

    writers = {"fastpack": fastpack.write_state_npys, "numpy.save": with_numpy}
    times = {how: [] for how in writers}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_restart(state, None, os.path.join(tmp, "restart"))
        back = load_restart_arrays(os.path.join(tmp, "restart"))
        if sorted(back) != sorted(arrays) or not all(
                np.array_equal(back[k], arrays[k]) for k in arrays):
            raise AssertionError("restart through fastpack reads back "
                                 "different")
        order = ["fastpack", "numpy.save", "numpy.save", "fastpack"] * 2
        for i, how in enumerate(order):
            directory = os.path.join(tmp, f"{how}_{i}")
            t0 = time.perf_counter()
            writers[how](directory, arrays)
            times[how].append(time.perf_counter() - t0)
        a, b = (os.path.join(tmp, f"{how}_{order.index(how)}")
                for how in writers)
        same = all(open(os.path.join(a, f), "rb").read()
                   == open(os.path.join(b, f), "rb").read()
                   for f in os.listdir(a))
    log(f"[13] C48/79 float32 restart, {len(arrays)} fields, "
        f"{nbytes / 1e6:.1f} MB, {len(order) // 2} writes each in turns: "
        + ", ".join(f"{how} " + " ".join(f"{t * 1e3:.1f}" for t in ts)
                    + f" ms (median {np.median(ts) * 1e3:.1f})"
                    for how, ts in times.items())
        + f"; files {'identical' if same else 'DIFFER'} on {card}")
    if not same:
        raise AssertionError("fastpack and numpy.save files differ")


# ---------------------------------------------------------------------------
# phase 14: ranks of a (t, 1, 1) layout, started through torchrun
# ---------------------------------------------------------------------------

# The C192 grid of tests/test_memory_feasibility.py:47 with the settings of
# its script (scripts/c384_memory.py:77-81): dycore only, k_split 1,
# n_split 6, dt 225 s, float32.
C192 = dict(k_split=1, n_split=6)
RANKS = 6


def _rank_log(rank, msg):
    if rank == 0:
        log(f"[14] {msg}")


def rank_pair_debug(comm, device, layouts):
    """14.1 and 15.1: two C12/79 float64 steps under pair_debug, the
    one-rank step on the card (replicated, on every rank) against the
    ranks of each layout (the first t x y ranks), gathered."""
    import torch.distributed as dist

    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.parallel.comm import Comm
    from pace_torch.parallel.partition import Partition
    from pace_torch.parallel.topology import get_topology
    from pace_torch.utils.pair_debug import (
        compare_under_placements,
        layout_placement,
        replicated,
    )

    # every rank takes part in creating each group
    groups = [None if int(np.prod(layout)) == comm.size
              else dist.new_group(list(range(int(np.prod(layout)))))
              for layout in layouts]
    out = {}
    for layout, group in zip(layouts, groups):
        if comm.rank >= int(np.prod(layout)):
            continue
        sub = comm if group is None else Comm(device, group)
        sizing, core, state = make_core(12, torch.float64, 225.0,
                                        device=device)

        def two_steps(state, grid, topo):
            stepper = DynamicalCore(core.config, sizing, grid, 225.0,
                                    topology=topo)
            for _ in range(2):
                state = stepper.step_dynamics(state)
            return state

        t0 = time.perf_counter()
        report = compare_under_placements(
            two_steps, (state, core.grid_data, get_topology(12)),
            replicated, layout_placement(Partition(layout, 12), sub),
            rtol=1e-12)
        worst = max(report, key=report.get)
        out["x".join(map(str, layout))] = dict(
            worst=worst, max_abs=report[worst],
            identical=all(v == 0.0 for v in report.values()),
            seconds=time.perf_counter() - t0)
        if not out["x".join(map(str, layout))]["identical"]:
            raise AssertionError(f"layout {layout} against one rank: not "
                                 f"identical, worst leaf {worst} "
                                 f"{report[worst]:.3e}")
    return out


def _gather_state(comm, state, names):
    """Every rank's fields of `state`, flattened into one buffer, gathered
    on rank 0: a list of {name: numpy array} by rank (None elsewhere)."""
    import torch.distributed as dist

    flat = torch.cat([getattr(state, k).reshape(-1) for k in names])
    if comm.backend == "gloo":
        flat = flat.cpu()
    shapes = [tuple(getattr(state, k).shape) for k in names]
    sizes = comm.all_gather([int(np.prod(s)) for s in shapes])
    every = comm.all_gather(shapes)
    total = max(sum(s) for s in sizes)
    buf = torch.cat([flat, flat.new_zeros(total - flat.numel())])
    parts = ([torch.empty_like(buf) for _ in range(comm.size)]
             if comm.rank == 0 else None)
    dist.gather(buf, parts, dst=0)
    if comm.rank != 0:
        return None
    out = []
    for part, shapes_r in zip(parts, every):
        fields, offset = {}, 0
        for name, shape in zip(names, shapes_r):
            size = int(np.prod(shape))
            fields[name] = (part[offset:offset + size].reshape(shape)
                            .cpu().numpy())
            offset += size
        out.append(fields)
    return out


def rank_c192(comm, device, n=192):
    """14.2: C192/79 float32 k1/n6 at (t, 1, 1) (t ranks), one warm-up and
    three timed steps on every rank; then the state gathered on rank 0
    against the same four steps of one process on the whole cube.  Returns
    rank 0's report (None elsewhere)."""
    import dataclasses

    from pace_torch.parallel.halo import RankTopology
    from pace_torch.parallel.partition import Partition

    rank, steps = comm.rank, 3
    partition = Partition((comm.size, 1, 1), n)
    t0 = time.perf_counter()
    sizing, core, state = make_core(
        n, torch.float32, 225.0, device=device,
        part=partition.part(rank),
        topology=RankTopology(partition, rank, comm), **C192)
    setup = time.perf_counter() - t0
    state = core.step_dynamics(state)
    torch.cuda.synchronize(device)
    names = [f.name for f in dataclasses.fields(state)]
    state_bytes = sum(getattr(state, k).nbytes for k in names)
    comm.barrier()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    reset_launches()
    comm.start_timing()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = core.step_dynamics(state)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = read_launches()
    exchange = comm.timing()
    peak = torch.cuda.max_memory_allocated(device)
    check_finite(14, state, sizing)
    expect = {k: v * steps for k, v in
              expected_launches(core.config).items()}
    if launches != expect:
        raise AssertionError(f"rank {rank}: launches {launches}, expected "
                             f"{expect}")
    mine = dict(rank=rank, device=str(device), setup_s=setup, ms=ms,
                launches=launches, exchanges=exchange["exchanges"] / steps,
                exchange_bytes=exchange["bytes_sent"] / steps,
                exchange_ms=(None if exchange["ms"] is None
                             else exchange["ms"] / steps),
                state_bytes=state_bytes,
                temp_bytes=peak - before, peak_bytes=peak)
    every = comm.all_gather(mine)
    parts = _gather_state(comm, state, names)
    del state, core
    torch.cuda.empty_cache()
    report = None
    if rank == 0:
        # the same four steps of one process on the whole cube, while the
        # other ranks wait
        sizing, core, full = make_core(n, torch.float32, 225.0,
                                       device=device, **C192)
        full = core.step_dynamics(full)
        torch.cuda.synchronize(device)
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            full = core.step_dynamics(full)
        torch.cuda.synchronize(device)
        ms_one = (time.perf_counter() - t0) / steps * 1e3
        launches_one = read_launches()
        differ, worst = [], (None, 0.0)
        for name in names:
            got = partition.gather([p[name] for p in parts])
            want = getattr(full, name).cpu().numpy()
            if not np.array_equal(got, want, equal_nan=True):
                differ.append(name)
                scale = np.nanmax(np.abs(want)) + 1e-30
                rel = float(np.nanmax(np.abs(got - want)) / scale)
                if rel > worst[1] or worst[0] is None:
                    worst = (name, rel)
        report = dict(ranks=every, ms_one=ms_one, launches_one=launches_one,
                      differ=differ, worst=worst)
        if differ:
            raise AssertionError(f"C{n} ranks against one process: {differ} "
                                 f"differ, worst {worst}")
    comm.barrier()
    return report


def rank_main(out: str) -> None:
    """`chip_smoke.py --ranks OUT`, one rank of phase 14 under torchrun:
    14.1 and 14.2 at (t, 1, 1), t the number of processes (6 in phase 14,
    on one card; on a host with a card a rank, `torchrun --nproc_per_node
    3 chip_smoke.py --ranks OUT` runs them over NCCL); rank 0 writes
    OUT/ranks.json."""
    from pace_torch.ops import _cuda
    from pace_torch.parallel import comm as comm_mod

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    device = comm_mod.rank_device("cuda")
    comm = comm_mod.init_process_group(device)
    _cuda.library()
    _rank_log(comm.rank, f"{comm.size} ranks started by torchrun on "
              f"{torch.cuda.device_count()} card(s): {comm.describe()}")
    result = dict(backend=comm.describe(), staging=comm.staging)
    result["pair_debug"] = rank_pair_debug(
        comm, device, [(comm.size, 1, 1), (2, 1, 1)])
    _rank_log(comm.rank, f"14.1 done: {result['pair_debug']}")
    result["c192"] = rank_c192(comm, device)
    if comm.rank == 0:
        with open(os.path.join(out, "ranks.json"), "w") as f:
            json.dump(result, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def torchrun(args, cwd, timeout, ranks=RANKS,
             tag="[14]") -> subprocess.CompletedProcess:
    """`torchrun --standalone --nproc_per_node RANKS ARGS` from `cwd`; a
    child that fails fails the script."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={ranks}", *args]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith(tag):
            log(line)
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        # the rank that failed first, and its own lines
        import re

        first = re.search(r"Root Cause.*?\n.*?rank\s*:\s*(\d+)",
                          proc.stderr, re.S)
        if first is not None:
            mine = [line for line in proc.stderr.splitlines()
                    if line.startswith(f"[rank{first.group(1)}]")]
            log("\n".join(mine[-80:]))
        # every rank's own last line: the exception each one raised
        last = {}
        for line in proc.stderr.splitlines():
            rank = re.match(r"\[rank(\d+)\]:\s*(\S.*)", line)
            if rank is not None:
                last[int(rank.group(1))] = rank.group(2)
        for rank in sorted(last):
            log(f"rank {rank}: {last[rank][:300]}")
        log(proc.stderr[-6000:])
        raise AssertionError(f"torchrun {' '.join(args)}: exit code "
                             f"{proc.returncode}")
    return proc


def check_replay(card) -> None:
    """14.4: one C12/79 float64 step recorded on the card, then tile 2
    alone, its halo calls replayed from the recording."""
    from pace_torch.parallel.partition import Partition
    from pace_torch.parallel.traffic import HaloTrafficRecorder

    sizing, core, state = make_core(12, torch.float64, 225.0)
    recorder = HaloTrafficRecorder.recording()
    with recorder:
        full = core.step_dynamics(state)
    path = os.path.join(REPO, "build", "phase14", "traffic.npz")
    recorder.save(path)
    tile = 2
    _, solo_core, solo = make_core(12, torch.float64, 225.0,
                                   part=Partition((6, 1, 1), 12)
                                   .part(tile))
    reset_launches()
    with HaloTrafficRecorder.load(path).replaying(tile=tile):
        solo = solo_core.step_dynamics(solo)
    launches = read_launches()
    check_launches(14, launches, core.config, 1)
    differ = [k for k in PROGNOSTICS if not torch.equal(
        torch.nan_to_num(getattr(solo, k)[0], 1e300),
        torch.nan_to_num(getattr(full, k)[tile], 1e300))]
    worst = max((float((getattr(solo, k)[0] - getattr(full, k)[tile])
                       .abs().nan_to_num(0.0).max())
                 / (float(getattr(full, k)[tile].abs().nan_to_num(0.0)
                          .max()) + 1e-30), k) for k in PROGNOSTICS)
    log(f"[14] 14.4 replay: {len(recorder.calls)} halo results recorded "
        f"({os.path.getsize(path) / 1e6:.1f} MB npz); tile {tile} stepped "
        f"alone from the recording: "
        + ("every prognostic field identical to the whole run's tile"
           if not differ else f"{differ} differ, worst {worst[1]} "
           f"{worst[0]:.3e}") + f" on {card}")
    if worst[0] > 1e-12:
        raise AssertionError(f"replayed tile: {worst}")


def compare_files(one: str, ranks: str, split=False, zarr=False) -> list:
    """Relative paths of the restart and diagnostics files of run `one`,
    each checked equal in run `ranks` (npz by their arrays, others byte
    for byte; with `zarr`, a zarr store's files too).  With `split` (ranks
    that split tiles) an .npy file may differ in its bytes where only a
    NaN's sign or payload differs: its values and NaNs must agree."""
    def wanted(d, f):
        return (f.endswith((".npy", ".npz", ".nc")) or f == "time.json"
                or (zarr and ".zarr" in os.path.join(d, f)))

    files = sorted(os.path.relpath(os.path.join(d, f), one)
                   for d, _, fs in os.walk(one) for f in fs if wanted(d, f))
    for name in files:
        a, b = os.path.join(one, name), os.path.join(ranks, name)
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                same = sorted(x.files) == sorted(y.files) and all(
                    np.array_equal(x[k], y[k],
                                   equal_nan=x[k].dtype.kind == "f")
                    for k in x.files)
        else:
            with open(a, "rb") as x, open(b, "rb") as y:
                same = x.read() == y.read()
            if not same and split and name.endswith(".npy"):
                x, y = np.load(a), np.load(b)
                same = np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        if not same:
            raise AssertionError(f"{name}: the ranks' file differs")
    return files


def run_ranks(card, phase9_c48: str) -> dict:
    """Phase 14.  Returns each kernel's launches on each rank in the C192
    run's timed steps."""
    import shutil

    t14 = time.perf_counter()
    out = os.path.join(REPO, "build", "phase14")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    torch.cuda.empty_cache()

    # 14.1 and 14.2 in one torchrun of six ranks
    torchrun([os.path.join(REPO, "chip_smoke.py"), "--ranks", out], REPO,
             timeout=900)
    with open(os.path.join(out, "ranks.json")) as f:
        res = json.load(f)
    log(f"[14] halo exchange: {res['backend']}")
    for layout, r in res["pair_debug"].items():
        log(f"[14] 14.1 C12/79 float64, two steps, pair_debug one rank "
            f"against layout {layout}: worst leaf {r['worst']} max abs "
            f"{r['max_abs']:.3e}, every leaf identical (required) "
            f"({r['seconds']:.1f} s)")
    c192 = res["c192"]
    for r in c192["ranks"]:
        log(f"[14] 14.2 C192/79 float32 k1/n6 rank {r['rank']} on "
            f"{r['device']}: set-up {r['setup_s']:.1f} s, "
            f"{r['ms']:.3f} ms/step, launches a step "
            + "/".join(str(r["launches"][k] // 3)
                       for k in ("K-T", "K-S", "K-F"))
            + f", {r['exchanges']:.0f} exchanges a step, "
            f"{r['exchange_bytes'] / 1e6:.3f} MB sent a step (from the "
            f"plan), exchange {r['exchange_ms']:.3f} ms a step (CUDA "
            f"events); tools memory: state {r['state_bytes']} bytes, "
            f"temporary {r['temp_bytes']}, peak {r['peak_bytes']}")
    slowest = max(r["ms"] for r in c192["ranks"])
    log(f"[14] 14.2 ms/step: one process on the whole cube "
        f"{c192['ms_one']:.3f} (launches a step "
        + "/".join(str(c192["launches_one"][k] // 3)
                   for k in ("K-T", "K-S", "K-F"))
        + f"), six ranks sharing the card {slowest:.3f} (slowest rank) on "
        f"{card}")
    log(f"[14] 14.2 gathered state after 4 steps against one process: "
        + ("all 32 fields identical" if not c192["differ"] else
           f"{c192['differ']} differ, worst {c192['worst']}"))
    if c192["differ"]:
        raise AssertionError(f"C192 ranks against one process: {c192}")

    # 14.3 c48_sections_perf.yaml at layout [6, 1, 1] through torchrun
    work = os.path.join(out, "c48_sections")
    path = yaml_copy("c48_sections_perf.yaml", work,
                     restart_config=dict(save_restart=True,
                                         intermediate_restart=[3]),
                     mesh=dict(layout=[RANKS, 1, 1]))
    t0 = time.perf_counter()
    torchrun(["-m", "pace_torch.driver.run", path, "--log-level",
              "WARNING"], work, timeout=600)
    with open(os.path.join(work, "c48_sections_perf.json")) as f:
        report = json.load(f)
    files = compare_files(phase9_c48, work)
    ms = np.mean([t["mainloop"] for t in report["times_per_step"][1:]]) * 1e3
    log(f"[14] 14.3 c48_sections_perf.yaml at layout [6, 1, 1] through "
        f"torchrun -m pace_torch.driver.run: {len(files)} restart (step 3 "
        f"and final) and diagnostics files equal to phase 9's one-rank run; "
        f"{len(report['times_per_step'])} steps, {ms:.3f} ms/step (mainloop "
        f"without step 1, slowest rank), SYPD {report['sypd']:.4f} "
        f"({time.perf_counter() - t0:.1f} s) on {card}")

    # 14.4 one tile from a recording
    check_replay(card)
    log(f"[14] phase 14 took {time.perf_counter() - t14:.0f} s")
    return {k: [r["launches"][k] for r in c192["ranks"]]
            for k in ("K-T", "K-S", "K-F")}


# ---------------------------------------------------------------------------
# phase 15: ranks that split tiles along x and y, started through torchrun
# ---------------------------------------------------------------------------

SPLIT_RANKS = 8
SPLIT_LAYOUTS = [(1, 2, 2), (2, 2, 2), (1, 2, 4)]
# c384_multihost_emulator.yaml cut to one card's size: 24 ranks of C24
C384_CUT = dict(nx_tile=24, mesh=dict(layout=[6, 2, 2], multihost=False,
                                      dcn_mesh_shape=[6, 1, 1]),
                minutes=5)


def _split_log(rank, msg):
    if rank == 0:
        log(f"[15] {msg}")


def rank_split_c96(comm, device, layout=(2, 2, 2), start_peak=None):
    """15.2: phase 8's coupled emulator step (the dycore and physics
    settings of c384_multihost_emulator.yaml at C96/79 float32, dt 150 s)
    behind the Driver at `layout`: one warm-up and two timed steps on every
    rank; then the state gathered on rank 0 against the same three steps
    of one process.  Returns rank 0's report (None elsewhere)."""
    import dataclasses

    from pace_torch.driver import Driver

    import resource

    def host_peak():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    # the host peak (kilobytes on Linux) after each stage: where the
    # rank's peak is set
    rank, steps = comm.rank, 2
    stages = [("kernels loaded", start_peak), ("after 15.1", host_peak())]
    t0 = time.perf_counter()
    driver = Driver.from_dict(emulator_driver_config(
        mesh=dict(layout=list(layout))))
    setup = time.perf_counter() - t0
    stages.append(("Driver built", host_peak()))
    driver.step()
    torch.cuda.synchronize(device)
    stages.append(("warm-up step", host_peak()))
    names = [f.name for f in dataclasses.fields(driver.state.dycore_state)]
    state_bytes = sum(getattr(driver.state.dycore_state, k).nbytes
                      for k in names)
    comm.barrier()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    reset_launches()
    driver.comm.start_timing()  # the Driver's own handle on the group
    t0 = time.perf_counter()
    for _ in range(steps):
        driver.step()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = read_launches()
    exchange = driver.comm.timing()
    peak = torch.cuda.max_memory_allocated(device)
    expect = {k: v * steps for k, v in
              expected_launches(driver.config.dycore_config).items()}
    if launches != expect:
        raise AssertionError(f"rank {rank}: launches {launches}, expected "
                             f"{expect}")
    dom = driver.dycore.domain
    stages.append(("timed steps", host_peak()))
    mine = dict(rank=rank, device=str(device), setup_s=setup, ms=ms,
                host_peak_bytes=stages[-1][1], host_stages=stages,
                block=[dom.Ni, dom.Nj], launches=launches,
                exchanges=exchange["exchanges"] / steps,
                exchange_bytes=exchange["bytes_sent"] / steps,
                exchange_ms=(None if exchange["ms"] is None
                             else exchange["ms"] / steps),
                state_bytes=state_bytes, temp_bytes=peak - before,
                peak_bytes=peak)
    every = comm.all_gather(mine)
    parts = _gather_state(comm, driver.state.dycore_state, names)
    partition = driver.partition
    del driver
    torch.cuda.empty_cache()
    report = None
    if rank == 0:
        # the same three steps of one process on the whole cube, while the
        # other ranks wait
        one = Driver.from_dict(emulator_driver_config())
        one.step()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            one.step()
        torch.cuda.synchronize(device)
        ms_one = (time.perf_counter() - t0) / steps * 1e3
        full = one.state.dycore_state
        check_finite(15, full, one.state.sizing)
        differ, worst = [], (None, 0.0)
        for name in names:
            got = partition.gather([p[name] for p in parts])
            want = getattr(full, name).cpu().numpy()
            if not np.array_equal(got, want, equal_nan=True):
                differ.append(name)
                scale = np.nanmax(np.abs(want)) + 1e-30
                rel = float(np.nanmax(np.abs(got - want)) / scale)
                if rel > worst[1] or worst[0] is None:
                    worst = (name, rel)
        report = dict(ranks=every, ms_one=ms_one, differ=differ,
                      worst=worst, fields=len(names))
        if differ:
            raise AssertionError(f"C96 ranks at {layout} against one "
                                 f"process: {differ} differ, worst {worst}")
        del one, full
        torch.cuda.empty_cache()
    comm.barrier()
    return report


def split_rank_main(out: str) -> None:
    """`chip_smoke.py --split-ranks OUT`, one rank of phase 15 under
    torchrun (SPLIT_RANKS processes on the one card): 15.1 and 15.2; rank
    0 writes OUT/split.json."""
    from pace_torch.ops import _cuda
    from pace_torch.parallel import comm as comm_mod

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    device = comm_mod.rank_device("cuda")
    comm = comm_mod.init_process_group(device)
    _cuda.library()
    import resource

    start_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    _split_log(comm.rank, f"{comm.size} ranks started by torchrun on "
               f"{torch.cuda.device_count()} card(s): {comm.describe()}")
    result = dict(backend=comm.describe())
    t0 = time.perf_counter()
    result["pair_debug"] = rank_pair_debug(comm, device, SPLIT_LAYOUTS)
    result["pair_debug_s"] = time.perf_counter() - t0
    _split_log(comm.rank, f"15.1 done: {result['pair_debug']}")
    t0 = time.perf_counter()
    result["c96"] = rank_split_c96(comm, device, start_peak=start_peak)
    result["c96_s"] = time.perf_counter() - t0
    if comm.rank == 0:
        with open(os.path.join(out, "split.json"), "w") as f:
            json.dump(result, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def run_split_ranks(card) -> tuple:
    """Phase 15.  Returns each kernel's launches on each rank in the C96
    run's timed steps, and each C96 rank's host peak in bytes."""
    import shutil

    t15 = time.perf_counter()
    out = os.path.join(REPO, "build", "phase15")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    write_emulator_weights()
    torch.cuda.empty_cache()

    # 15.1 and 15.2 in one torchrun of eight ranks
    t0 = time.perf_counter()
    torchrun([os.path.join(REPO, "chip_smoke.py"), "--split-ranks", out],
             REPO, timeout=900, ranks=SPLIT_RANKS, tag="[15]")
    with open(os.path.join(out, "split.json")) as f:
        res = json.load(f)
    log(f"[15] halo exchange: {res['backend']} (torchrun "
        f"{time.perf_counter() - t0:.1f} s)")
    for layout, r in res["pair_debug"].items():
        log(f"[15] 15.1 C12/79 float64, two steps, pair_debug one rank "
            f"against layout {layout}: worst leaf {r['worst']} max abs "
            f"{r['max_abs']:.3e}, every leaf identical (required) "
            f"({r['seconds']:.1f} s)")
    c96 = res["c96"]
    for r in c96["ranks"]:
        log(f"[15] 15.2 C96/79 float32 k2/n3 emulator at (2, 2, 2) rank "
            f"{r['rank']} on {r['device']}, block {r['block']}: set-up "
            f"{r['setup_s']:.1f} s, {r['ms']:.3f} ms/step, launches a step "
            + "/".join(str(r["launches"][k] // 2)
                       for k in ("K-T", "K-S", "K-F"))
            + f", {r['exchanges']:.0f} exchanges a step, "
            f"{r['exchange_bytes'] / 1e6:.3f} MB sent a step (from the "
            f"plan), exchange {r['exchange_ms']:.3f} ms a step (CUDA "
            f"events); memory: state {r['state_bytes']} bytes, temporary "
            f"{r['temp_bytes']}, peak {r['peak_bytes']}; host peak "
            f"{r['host_peak_bytes']} bytes (after each stage: "
            + ", ".join(f"{k} {v}" for k, v in r["host_stages"]) + ")")
    slowest = max(r["ms"] for r in c96["ranks"])
    log(f"[15] 15.2 ms/step: one process on the whole cube "
        f"{c96['ms_one']:.3f}, eight ranks sharing the card {slowest:.3f} "
        f"(slowest rank) on {card}; 15.1 {res['pair_debug_s']:.1f} s, 15.2 "
        f"{res['c96_s']:.1f} s")
    log(f"[15] 15.2 gathered state after 3 steps against one process: "
        + (f"all {c96['fields']} fields identical" if not c96["differ"]
           else f"{c96['differ']} differ, worst {c96['worst']}"))
    if c96["differ"]:
        raise AssertionError(f"C96 ranks against one process: {c96}")

    # 15.3 c384_multihost_emulator.yaml, cut to C24 and 24 ranks, through
    # torchrun against the one-rank run of the same cut yaml
    t0 = time.perf_counter()
    one = yaml_copy("c384_multihost_emulator.yaml",
                    os.path.join(out, "c384_one"),
                    **dict(C384_CUT, mesh=dict(layout=[1, 1, 1])))
    run_cli(one)
    t_one = time.perf_counter() - t0
    work = os.path.join(out, "c384_split")
    path = yaml_copy("c384_multihost_emulator.yaml", work, **C384_CUT)
    layout = C384_CUT["mesh"]["layout"]
    ranks = int(np.prod(layout))
    t0 = time.perf_counter()
    torchrun(["-m", "pace_torch.driver.run", path, "--log-level",
              "WARNING"], work, timeout=600, ranks=ranks, tag="[15]")
    t_split = time.perf_counter() - t0
    files = compare_files(os.path.dirname(one), work, split=True, zarr=True)
    with open(os.path.join(work, "c384_emulator_perf.json")) as f:
        report = json.load(f)
    ms = np.mean([t["mainloop"] for t in report["times_per_step"]]) * 1e3
    stores = sorted({f.split(os.sep)[1] for f in files if os.sep in f})
    log(f"[15] 15.3 c384_multihost_emulator.yaml cut to nx_tile 24, layout "
        f"{layout} ({ranks} ranks), multihost false, 2 steps, through "
        f"torchrun -m pace_torch.driver.run: {len(files)} diagnostics "
        f"files equal to the one-rank run's ({', '.join(stores)}); "
        f"{ms:.3f} ms/step (mainloop, slowest rank), SYPD "
        f"{report['sypd']:.4f}; one rank {t_one:.1f} s, {ranks} ranks "
        f"{t_split:.1f} s on {card}")
    if not files:
        raise AssertionError("15.3: the cut yaml wrote no files to compare")
    log(f"[15] phase 15 took {time.perf_counter() - t15:.0f} s")
    return ({k: [r["launches"][k] for r in c96["ranks"]]
             for k in ("K-T", "K-S", "K-F")},
            [r["host_peak_bytes"] for r in c96["ranks"]])


# ---------------------------------------------------------------------------
# phase 16: each rank builds only its own block of the initial state
# ---------------------------------------------------------------------------

C384_YAML = "c384_multihost_emulator.yaml"
# 16.1: ranks of the yaml's [6, 4, 4] mesh (hosts [6, 1, 1]) at n = 384,
# each built alone: tile 0's south-west corner box, a west-edge box, an
# interior box (its halo all other ranks' compute points) and tile 5's
# north-east corner box
LOCAL_RANKS = (0, 1, 5, 95)
# the most a rank's build may add to its process's host memory, as a share
# of what the whole cube's build adds (PERF.md section 2)
LOCAL_SHARE = 0.10
# 16.2: the yaml cut to nx_tile 96 at [6, 2, 2], 24 ranks each holding
# 48 x 48 cells of one tile.  At nx_tile 192 (96 x 96 cells, the box of a
# C384 [6, 4, 4] rank) the host holds the 24 ranks but the card does not:
# they need more than its 79 GB (PERF.md section 6)
C384_LOCAL = dict(mesh=dict(layout=[6, 2, 2], multihost=False,
                            dcn_mesh_shape=[6, 1, 1]), minutes=5)
LOCAL_N = 96
# the processes phase 16 starts beside other phases; the script stops those
# still running when it ends
BACKGROUND = []


def _log16(msg):
    log(f"[16] {msg}")


def _grid_leaves(arrays: dict) -> dict:
    """{"bundle/name": leaf} of `grid_arrays_numpy`'s nested leaves."""
    return {f"{bundle}/{name}": np.asarray(value)
            for bundle, leaves in arrays.items()
            for name, value in leaves.items()}


def _cut_grid_leaves(leaves: dict, partition, rank: int) -> dict:
    """A whole-cube grid's leaves cut to `rank` as `GridData.from_numpy`
    cuts them (the vertical leaves and the scalars whole)."""
    from pace_torch.grid.generation import EDGE_TABLE_AXIS

    out = {}
    for key, value in leaves.items():
        bundle, name = key.split("/")
        if bundle != "vertical" and value.ndim >= 2:
            value = partition.scatter(value, rank,
                                      axis=EDGE_TABLE_AXIS.get(name))
        out[key] = value
    return out


def local_build_main(out: str, which: str, device="cuda") -> None:
    """`chip_smoke.py --local-build OUT WHICH`, one process of 16.1: rank
    WHICH of c384_multihost_emulator.yaml's mesh builds its grid and its
    initial state alone (float32 on `device`; its metric terms evaluated
    at its block's points, `grid/points.py`), or with WHICH `whole` the
    whole cube is built as one process builds it.  Writes OUT/WHICH.json
    (seconds, host peak, device bytes, the host's resident and peak
    bytes after each stage of the build) and the float64 host arrays
    before the cast, the grid's leaves under "grid/...": a rank's own
    (OUT/rank<r>.npz), or the whole cube's cut to each of LOCAL_RANKS
    (OUT/cut<r>.npz)."""
    import dataclasses

    from pace_torch.driver import DriverConfig
    from pace_torch.driver.performance import host_peak_bytes
    from pace_torch.grid import eta
    from pace_torch.grid.generation import (
        GridData,
        grid_arrays_numpy,
        raw_metric_terms,
    )
    from pace_torch.models.fv3.init.baroclinic import (
        init_baroclinic_state_numpy,
    )
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.parallel.partition import Partition
    from pace_torch.utils.gridtools import GridSizing

    # ru_maxrss at the start: a child of a large process starts from its
    # parent's resident size there
    start_maxrss = host_peak_bytes()
    config = DriverConfig.from_yaml(os.path.join(EXAMPLES, C384_YAML))
    if config.initialization.type != "baroclinic":
        raise AssertionError(f"{C384_YAML} starts from "
                             f"{config.initialization.type}")
    n, nz = config.nx_tile, config.nz
    partition = Partition(config.mesh.layout, n,
                          dcn_mesh_shape=config.mesh.dcn_mesh_shape)
    part = None if which == "whole" else partition.part(int(which))
    if device == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
    # what the process holds before the build: on the card's host about
    # 5 GB (PERF.md section 6), pages of the CUDA libraries that the
    # host's processes share
    base = host_rss_bytes()
    stages = []
    t0 = time.perf_counter()
    with RssPeak() as sampled:
        def stage(name):
            if device == "cuda":
                torch.cuda.synchronize()
            stages.append(dict(stage=name, rss=host_rss_bytes(),
                               peak=sampled.peak))

        grid_arrays = grid_arrays_numpy(n, nz, part=part)
        stage("grid terms")
        grid = GridData.from_numpy(grid_arrays, device, torch.float32)
        stage("grid on the device")
        arrays = init_baroclinic_state_numpy(
            raw_metric_terms(n, 3, part),
            eta.set_hybrid_pressure_coefficients(nz), GridSizing(n, nz),
            part=part)
        stage("state arrays")
        state = DycoreState.from_numpy(arrays, device, torch.float32)
        stage("state on the device")
    seconds = time.perf_counter() - t0
    report = dict(
        which=which, seconds=seconds, host_peak_bytes=sampled.peak,
        host_base_bytes=base, stages=stages, maxrss=host_peak_bytes(),
        start_maxrss=start_maxrss,
        device_bytes=(torch.cuda.memory_allocated() if device == "cuda"
                      else None),
        state_bytes=sum(getattr(state, f.name).nbytes
                        for f in dataclasses.fields(state)),
        held=list(state.u.shape[:3]),
        host_state_bytes=sum(a.nbytes for a in arrays.values()),
        host_grid_bytes=sum(np.asarray(v).nbytes for leaves in
                            grid_arrays.values() for v in leaves.values()))
    del grid, state
    leaves = _grid_leaves(grid_arrays)
    if part is None:
        for rank in LOCAL_RANKS:
            np.savez(os.path.join(out, f"cut{rank}.npz"),
                     **{k: partition.scatter(v, rank)
                        for k, v in arrays.items()},
                     **{f"grid/{k}": v for k, v in _cut_grid_leaves(
                         leaves, partition, rank).items()})
    else:
        np.savez(os.path.join(out, f"rank{which}.npz"), **arrays,
                 **{f"grid/{k}": v for k, v in leaves.items()})
    with open(os.path.join(out, f"{which}.json"), "w") as f:
        json.dump(report, f)


def same_bits(a, b) -> bool:
    """NaN where the other is NaN, elsewhere equal bit for bit (for
    floats; other arrays equal)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    bits = np.dtype(f"i{a.dtype.itemsize}")
    return bool(np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(bits), b[~nan].view(bits)))


def host_rss_bytes() -> int:
    """This process's resident host memory now (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


class RssPeak:
    """The largest resident size of this process (/proc/self/status
    VmRSS) while the block runs, read every millisecond by a thread.
    `ru_maxrss` starts from the resident size of the parent a process was
    forked from (Linux carries it across exec), and the card's host has
    no VmHWM, nor lets a process reset it."""

    def __enter__(self):
        import threading

        self.peak, self._stop = host_rss_bytes(), threading.Event()

        def sample():
            while not self._stop.wait(0.001):
                self.peak = max(self.peak, host_rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_bytes())


def start_local_builds(out: str) -> list:
    """16.1's processes, all started together: the whole cube and each of
    LOCAL_RANKS.  Returns (which, Popen) pairs."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    procs = []
    for which in ("whole",) + tuple(str(r) for r in LOCAL_RANKS):
        logf = open(os.path.join(out, f"{which}.log"), "w")
        procs.append((which, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--local-build", out, which],
            stdout=logf, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))))
        BACKGROUND.append(procs[-1][1])
        logf.close()
    return procs


def check_local_builds(out: str, procs: list, card: str) -> tuple:
    """16.1: wait for the processes; every rank's float64 host arrays, of
    its grid and of its state, equal the whole cube's cut to it, every
    leaf, bit for bit (NaN for NaN); the host memory each rank's build
    adds (its peak over what the process held before, the libraries'
    shared pages) at most LOCAL_SHARE of what the whole cube's adds.
    Returns (the largest base, the largest rank addition), in bytes."""
    for which, proc in procs:
        if proc.wait(timeout=600) != 0:
            with open(os.path.join(out, f"{which}.log")) as f:
                log(f.read()[-4000:])
            raise AssertionError(f"16.1: the build of {which} failed "
                                 f"({proc.returncode})")
    reports = {}
    for which, _ in procs:
        with open(os.path.join(out, f"{which}.json")) as f:
            reports[which] = json.load(f)
    for r in reports.values():
        r["added"] = r["host_peak_bytes"] - r["host_base_bytes"]
    whole = reports.pop("whole")
    _log16(f"16.1 {C384_YAML} at n=384, [6, 4, 4] (hosts [6, 1, 1]): the "
           f"whole cube as one process builds it, grid and state float32 on "
           f"the card: {whole['seconds']:.1f} s, host peak (resident "
           f"size sampled every ms) "
           f"{whole['host_peak_bytes']} bytes ({whole['added']} over the "
           f"{whole['host_base_bytes']} the process held before), device "
           f"{whole['device_bytes']} bytes (state {whole['state_bytes']}; "
           f"float64 host state {whole['host_state_bytes']}, grid "
           f"{whole['host_grid_bytes']}; ru_maxrss {whole['maxrss']}, "
           f"{whole['start_maxrss']} at the process's start) on {card}")
    _log16("16.1 whole cube: host bytes after each stage (resident, "
           "peak): " + "; ".join(f"{s['stage']} {s['rss']}, {s['peak']}"
                                 for s in whole["stages"]))
    for rank in LOCAL_RANKS:
        r = reports[str(rank)]
        with np.load(os.path.join(out, f"rank{rank}.npz")) as got, \
                np.load(os.path.join(out, f"cut{rank}.npz")) as want:
            if sorted(got.files) != sorted(want.files):
                raise AssertionError(f"16.1 rank {rank}: fields "
                                     f"{got.files} against {want.files}")
            differ = [k for k in got.files
                      if not same_bits(got[k], want[k])]
            grid = sum(k.startswith("grid/") for k in got.files)
        share = r["added"] / whole["added"]
        _log16(f"16.1 rank {rank} built alone, block {r['held']}: "
               f"{r['seconds']:.1f} s, host peak (sampled) "
               f"{r['host_peak_bytes']} "
               f"bytes ({r['added']} over the {r['host_base_bytes']} held "
               f"before: {share:.4f} of the whole cube's), device "
               f"{r['device_bytes']} bytes (state {r['state_bytes']}; "
               f"float64 host state {r['host_state_bytes']}, grid "
               f"{r['host_grid_bytes']}; ru_maxrss {r['maxrss']}, "
               f"{r['start_maxrss']} at the process's start); "
               + (f"every float64 leaf, {grid} of the grid's (its four "
                  "area extremes among them), identical to the whole "
                  "cube's cut bit for bit (required)" if not differ
                  else f"{differ} differ"))
        _log16(f"16.1 rank {rank} host bytes after each stage (resident, "
               f"peak): " + "; ".join(
                   f"{s['stage']} {s['rss']}, {s['peak']}"
                   for s in r["stages"]))
        if differ:
            raise AssertionError(f"16.1 rank {rank}: {differ} differ from "
                                 "the whole cube's cut")
        if not share <= LOCAL_SHARE:
            raise AssertionError(f"16.1 rank {rank}: the host memory its "
                                 f"build adds, {r['added']}, is above "
                                 f"{LOCAL_SHARE} of the whole cube's "
                                 f"{whole['added']}")
    return (max(r["host_base_bytes"] for r in reports.values()),
            max(r["added"] for r in reports.values()))


# 16.3: rank 0's writes of c384_multihost_emulator.yaml's [6, 4, 4] ranks
# at n = 384, one field at a time: a float32 restart of the state and one
# diagnostics record of the yaml's `names`, in one process, every other
# rank's block made from the seed
ROOT_WRITES = ("restart", "diagnostics")
ROOT_WRITE_SEED = 16
# the most a write may add to its process's host memory, in whole-cube
# fields of the largest size (PERF.md section 2)
ROOT_WRITE_FIELDS = 3.0


def seeded_block(seed: int, name: str, rank: int, shape) -> np.ndarray:
    """Rank `rank`'s float32 block of field `name`, made from `seed`."""
    import zlib

    key = [seed, zlib.crc32(name.encode()), rank]
    return np.random.default_rng(key).random(tuple(shape),
                                             dtype=np.float32)


class SeededRanks:
    """A stand-in for the process group of a layout's ranks as rank 0
    sees it: `gather_blocks` yields rank 0's own block and then each other
    rank's made from the seed, one at a time, for the fields `names` in
    the order they come."""

    rank = 0

    def __init__(self, partition, seed: int, names):
        self.partition, self.seed = partition, seed
        self.size, self.names = partition.size, list(names)

    def gather_blocks(self, block, shapes, root=0):
        name = self.names.pop(0)
        yield block
        for rank in range(1, self.size):
            yield seeded_block(self.seed, name, rank, shapes[rank])


def root_write_main(out: str, which: str, seed: str) -> None:
    """`chip_smoke.py --root-write OUT WHICH SEED`, one process of 16.3:
    rank 0 of c384_multihost_emulator.yaml's mesh writes a float32 restart
    (WHICH `restart`) or one diagnostics record of the yaml's names in its
    format (`diagnostics`) through the port's writers, with every other
    rank's block of each field made from SEED as the stand-in for the
    gather delivers it; then reads the files back against the blocks and
    deletes them.  Writes OUT/root_<WHICH>.json: seconds, the host bytes
    the write added over what the process held before it, the largest
    whole-cube field's bytes, the bytes written."""
    import datetime

    from pace_torch.driver import DriverConfig
    from pace_torch.driver.diagnostics import DiagnosticsConfig
    from pace_torch.driver.performance import host_peak_bytes
    from pace_torch.driver.restart import write_restart
    from pace_torch.models.fv3.state import DycoreState, zeros_numpy
    from pace_torch.parallel.partition import Partition
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.utils.zarrlite import read_zarr_array

    seed = int(seed)
    config = DriverConfig.from_yaml(os.path.join(EXAMPLES, C384_YAML))
    n, nz = config.nx_tile, config.nz
    sizing = GridSizing(n, nz)
    partition = Partition(config.mesh.layout, n,
                          dcn_mesh_shape=config.mesh.dcn_mesh_shape)
    part = partition.part(0)
    state = DycoreState.from_numpy(
        {name: seeded_block(seed, name, 0, a.shape)
         for name, a in zeros_numpy(sizing, part).items()}, "cpu",
        torch.float32)
    diag = config.diagnostics_config
    names = (list(zeros_numpy(sizing, part)) if which == "restart"
             else list(diag.names))
    ranks = (partition, SeededRanks(partition, seed, names))
    path = os.path.join(out, f"root_{which}")
    # the bytes of the largest whole-cube field written, float32
    largest = max(4 * 6 * partition.N ** 2
                  * int(np.prod(getattr(state, name).shape[3:]))
                  for name in names)
    base = host_rss_bytes()
    before = host_peak_bytes()
    t0 = time.perf_counter()
    with RssPeak() as sampled:
        if which == "restart":
            write_restart(state, None, path, "npz", ranks)
        else:
            DiagnosticsConfig(path=path, output_format=diag.output_format,
                              names=names).diagnostics_factory(
                sizing, ranks).store(datetime.datetime(2000, 1, 1), state)
    seconds = time.perf_counter() - t0
    peak, maxrss_after = sampled.peak, host_peak_bytes()
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(path) for f in fs)
    # read back: each rank's owned box of each field against its block
    t0 = time.perf_counter()
    h = sizing.halo
    for name in names:
        if which == "restart":
            data = np.load(os.path.join(path, "dycore_state", f"{name}.npy"),
                           mmap_mode="r")
            lo = (0, 0)
        else:
            data = read_zarr_array(os.path.join(path, "state.zarr",
                                                name))[0]
            lo = (h, h)
        shapes = partition.part_shapes(getattr(state, name).shape[3:])
        for rank in range(partition.size):
            b, lb = partition.box(rank), partition.local_box(rank)
            i0, i1 = max(b.i0, lo[0]), min(b.i1, lo[0] + data.shape[1])
            j0, j1 = max(b.j0, lo[1]), min(b.j1, lo[1] + data.shape[2])
            block = seeded_block(seed, name, rank, shapes[rank])
            want = block[:, i0 - lb.i0:i1 - lb.i0, j0 - lb.j0:j1 - lb.j0]
            got = data[b.t0:b.t1, i0 - lo[0]:i1 - lo[0],
                       j0 - lo[1]:j1 - lo[1]]
            if not np.array_equal(got, want):
                raise AssertionError(f"16.3 {which}: {name} of rank {rank} "
                                     "differs from its block")
        del data
    check_s = time.perf_counter() - t0
    import shutil

    shutil.rmtree(path)
    with open(os.path.join(out, f"root_{which}.json"), "w") as f:
        json.dump(dict(which=which, fields=len(names), seconds=seconds,
                       check_seconds=check_s, base=base, peak=peak,
                       added=peak - base, maxrss_before=before,
                       maxrss_after=maxrss_after,
                       largest_field_bytes=largest, written_bytes=written,
                       ranks=partition.size,
                       layout=list(partition.layout)), f)


def start_root_writes(out: str) -> list:
    """16.3's processes, one a write.  Returns (which, Popen) pairs."""
    procs = []
    for which in ROOT_WRITES:
        logf = open(os.path.join(out, f"root_{which}.log"), "w")
        procs.append((which, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--root-write", out, which, str(ROOT_WRITE_SEED)],
            stdout=logf, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))))
        BACKGROUND.append(procs[-1][1])
        logf.close()
    return procs


def check_root_writes(out: str, procs: list, card: str) -> None:
    """16.3: each write's files read back equal to the blocks (checked in
    its process), and what the write added to the host at most
    ROOT_WRITE_FIELDS whole-cube fields of the largest size."""
    for which, proc in procs:
        if proc.wait(timeout=900) != 0:
            with open(os.path.join(out, f"root_{which}.log")) as f:
                log(f.read()[-4000:])
            raise AssertionError(f"16.3: the {which} write failed "
                                 f"({proc.returncode})")
        with open(os.path.join(out, f"root_{which}.json")) as f:
            r = json.load(f)
        fields = r["added"] / r["largest_field_bytes"]
        _log16(f"16.3 rank 0 of {C384_YAML} at n=384, {r['ranks']} ranks "
               f"of {r['layout']}: the {which} ({r['fields']} fields, "
               f"{r['written_bytes']} bytes written, the other ranks' "
               f"blocks made from seed {ROOT_WRITE_SEED}) one field at a "
               f"time in {r['seconds']:.1f} s, read back equal to every "
               f"rank's block in {r['check_seconds']:.1f} s; the write "
               f"added {r['added']} host bytes over the {r['base']} held "
               f"before ({fields:.3f} x the largest whole-cube field's "
               f"{r['largest_field_bytes']}; resident size sampled every "
               f"ms; ru_maxrss {r['maxrss_before']} before the write, "
               f"{r['maxrss_after']} after) on {card}")
        if not fields <= ROOT_WRITE_FIELDS:
            raise AssertionError(f"16.3 {which}: the write added "
                                 f"{r['added']} bytes, {fields:.3f} whole-"
                                 f"cube fields (at most "
                                 f"{ROOT_WRITE_FIELDS})")


def local_yaml_copy(n, work, mesh=None) -> str:
    """16.2's cut yaml at nx_tile `n` in `work`: its ranks, or with `mesh`
    another mesh section (one rank: {"layout": [1, 1, 1]})."""
    return yaml_copy(C384_YAML, work, **dict(
        C384_LOCAL, nx_tile=n, mesh=mesh or C384_LOCAL["mesh"]))


def start_one_rank_run(n, out) -> tuple:
    """16.2's one-rank run of the cut yaml, in its own process (it runs
    beside 16.1's builds).  Returns (config path, Popen)."""
    path = local_yaml_copy(n, os.path.join(out, f"c{n}_one"),
                           dict(layout=[1, 1, 1]))
    logf = open(os.path.join(out, f"c{n}_one.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pace_torch.driver.run", path,
         "--log-level", "WARNING"], cwd=os.path.dirname(path),
        stdout=logf, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    BACKGROUND.append(proc)
    logf.close()
    return path, proc


def wait_one_rank_run(n, out, path, proc) -> None:
    if proc.wait(timeout=600) != 0:
        with open(os.path.join(out, f"c{n}_one.log")) as f:
            log(f.read()[-4000:])
        raise AssertionError(f"16.2: the one-rank run at nx_tile {n} "
                             f"failed ({proc.returncode})")


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


LOCAL_OUT = os.path.join(REPO, "build", "phase16")


def start_local_init() -> dict:
    """Phase 16's processes that need neither the card's attention nor
    the host's memory for long: 16.1's builds, 16.3's writes and the
    one-rank run of 16.2's cut yaml at nx_tile LOCAL_N. `main` starts
    them before phase 11 (a single process that waits on its launches),
    so that they run beside phases 11 to 13."""
    procs = start_local_builds(LOCAL_OUT)
    return dict(t0=time.perf_counter(), procs=procs,
                writes=start_root_writes(LOCAL_OUT),
                one=start_one_rank_run(LOCAL_N, LOCAL_OUT))


def run_local_init(card, started: dict, split_peaks=None) -> None:
    """Phase 16: 16.1, the builds of LOCAL_RANKS and of the whole cube
    (`started`), against each other; then 16.2, the cut yaml's 24 ranks
    through torchrun against the one-rank run.  `split_peaks`, the host
    peaks of phase 15.2's ranks where phase 15 ran, bound what a rank of
    16.2 adds to the host."""
    t16 = time.perf_counter()
    out, n, one = LOCAL_OUT, LOCAL_N, started["one"]
    base, added = check_local_builds(out, started["procs"], card)
    for name in os.listdir(out):
        if name.endswith(".npz"):
            os.remove(os.path.join(out, name))
    check_root_writes(out, started["writes"], card)
    log(f"[16] 16.1's and 16.3's processes started "
        f"{t16 - started['t0']:.0f} s before phase 16; their checks took "
        f"{time.perf_counter() - t16:.0f} s")
    wait_one_rank_run(n, out, *one)

    layout = C384_LOCAL["mesh"]["layout"]
    ranks = int(np.prod(layout))
    # what a rank of 16.2 adds to the host over the pages every torch
    # process shares: 15.2's ranks hold blocks of the same C96 cube, step
    # the same emulator and gather the state besides; without phase 15,
    # the one-rank run of the same cut yaml, which holds the whole cube
    if split_peaks:
        per_rank, source = max(split_peaks) - base, "15.2's C96 ranks"
    else:
        with open(os.path.join(os.path.dirname(one[0]),
                               "c384_emulator_perf.json")) as f:
            per_rank = json.load(f)["ranks"][0]["host_peak_bytes"] - base
        source = "the one-rank run of the cut yaml"
    available = host_available_bytes()
    need = base + ranks * per_rank
    summary = (f"{available} bytes available; {ranks} ranks at "
               f"{per_rank} each ({source}) over a shared {base} need at "
               f"most {need}")
    _log16(f"16.2 the host has {summary}")
    if need > 0.9 * available:
        raise AssertionError(f"16.2: the host cannot hold {ranks} ranks: "
                             f"{summary}")
    work = os.path.join(out, f"c{n}_split")
    path = local_yaml_copy(n, work)
    torch.cuda.empty_cache()  # the card's memory is the 24 ranks'
    free, total = torch.cuda.mem_get_info()
    _log16(f"16.2 the card has {free} of {total} bytes free; this process "
           f"holds {torch.cuda.memory_reserved()}")
    t0 = time.perf_counter()
    torchrun(["-m", "pace_torch.driver.run", path, "--log-level",
              "WARNING"], work, timeout=600, ranks=ranks, tag="[16]")
    t_split = time.perf_counter() - t0
    files = compare_files(os.path.dirname(one[0]), work, split=True,
                          zarr=True)
    with open(os.path.join(work, "c384_emulator_perf.json")) as f:
        report = json.load(f)
    if not files:
        raise AssertionError("16.2: the cut yaml wrote no files to compare")
    peaks = [r["host_peak_bytes"] for r in report["ranks"]]
    cards = [r["device_peak_bytes"] for r in report["ranks"]]
    starts = [r["initialization"] for r in report["ranks"]]
    _log16(f"16.2 {C384_YAML} cut to nx_tile {n}, layout {layout} "
           f"({ranks} ranks of {n // 2} x {n // 2} cells), 2 steps through "
           f"torchrun -m pace_torch.driver.run: {len(files)} files equal "
           f"to the one-rank run's; host available before "
           f"{available} bytes; rank 0's host peak {peaks[0]} bytes "
           f"(it writes the files), the other ranks' {min(peaks[1:])}-"
           f"{max(peaks[1:])} ({peaks[1:]}; sum of all {sum(peaks)}), "
           f"card peak {min(cards)}-{max(cards)} bytes (sum "
           f"{sum(cards)}), initialization {min(starts):.1f}-"
           f"{max(starts):.1f} s; {ranks} ranks {t_split:.1f} s on {card}")
    log(f"[16] phase 16 took {time.perf_counter() - t16:.0f} s")


def main(phases=None) -> None:
    """Every phase; with `phases` (a set of phase numbers, from `--phases
    2,15`) only those and phases 0 and 1, and no result lines."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    from pace_torch.ops import _cuda

    def run(phase):
        return phases is None or phase in phases

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
    if run(2):
        check_transport(results)
        check_sim1(results)
        check_fillz(results)
        check_rank_shapes()
        check_split_shapes()

    # ---- phase 3
    if run(3):
        check_c12_digests()

    # ---- phase 4: the main path
    if run(4):
        launches = run_path(4, 48, 450.0, 2, 5, card, k_split=1, n_split=2)

    # ---- phase 5: the C96 SHiELD-like settings
    if run(5):
        run_path(5, 96, 300.0, 1, 2, card, **SHIELD)

    # ---- phase 6: the production configuration of bench.py
    if run(6):
        run_path(6, 48, 450.0, 1, 2, card, k_split=2, n_split=6)

    # ---- phases 7, 7b, 8: the coupled step
    if run(7):
        coupled = run_coupled(card)
        check_card_against_cpu()
    if run(8):
        run_emulator(card)

    # ---- phase 9: the yaml entry point
    if run(9):
        t9 = time.perf_counter()
        yaml_launches = run_yaml_configs(card)
        log(f"[9] phase 9 took {time.perf_counter() - t9:.0f} s")

    # ---- phase 10: the dycore branches
    if run(10):
        t10 = time.perf_counter()
        subcycle = run_branches(card)
        log(f"[10] phase 10 took {time.perf_counter() - t10:.0f} s")

    # ---- phase 16's builds start here and run beside phases 11 to 13
    if run(16):
        local_init = start_local_init()

    # ---- phase 11: the JW day-1 anchor
    if run(11):
        check_jw_day1()

    # ---- phase 12: the other entry points
    if run(12):
        t12 = time.perf_counter()
        run_entry_points(card)
        log(f"[12] phase 12 took {time.perf_counter() - t12:.0f} s")

    # ---- phase 13: the savepoint harness, tools and the restart writer
    if run(13):
        t13 = time.perf_counter()
        import pace_torch.utils.translate_cases_grid  # noqa: F401
        import pace_torch.utils.translate_cases_physics  # noqa: F401
        from pace_torch.utils.translate_cases import CASES

        case_savepoints(sorted(CASES), 12, (1, 1))
        case_savepoints(KERNEL_CASES, 48, (3, 3))
        check_tools(card)
        check_fastpack(card)
        log(f"[13] phase 13 took {time.perf_counter() - t13:.0f} s")

    # ---- phase 14: ranks of a (t, 1, 1) layout through torchrun (needs
    # phase 9's files)
    if run(14) and run(9):
        launches_ranks = run_ranks(card, PHASE9_C48)

    # ---- phase 15: ranks that split tiles along x and y through torchrun
    split_peaks = None
    if run(15):
        launches_split, split_peaks = run_split_ranks(card)

    # ---- phase 16: each rank builds only its own part of the initial state
    if run(16):
        run_local_init(card, local_init, split_peaks)
    log(f"[16] all phases took {time.perf_counter() - started:.0f} s")
    if phases is not None:
        log(f"phases {sorted(phases)} only: no result lines")
        return

    kernels = [
        dict(**KERNELS[k], route="cuda", launches=launches[k],
             launches_coupled=coupled[k], launches_yaml=yaml_launches[k],
             launches_subcycle=subcycle[k],
             launches_ranks=launches_ranks[k],
             launches_split_ranks=launches_split[k],
             max_abs_err=results[k][0],
             ms=results[k][1],
             plain_ms=results[k][2], bound_ms=results[k][3],
             bound_by=results[k][4], library_ms=None)
        for k in ("K-T", "K-S", "K-F")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

def stop_background() -> None:
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--split-ranks"]:
        split_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--local-build"]:
        local_build_main(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--root-write"]:
        root_write_main(*sys.argv[2:5])
    else:
        try:
            main({int(p) for p in sys.argv[2].split(",")}
                 if sys.argv[1:2] == ["--phases"] else None)
        finally:
            stop_background()
