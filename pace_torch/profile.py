"""Device-time breakdown of the main path on one GPU.

    python -m pace_torch.profile

Runs the C48/79 float32 dycore step (k_split=1, n_split=2, dt=450 s)
for 3 unprofiled steps and then 3 under torch.profiler, after two warm-up
steps, and prints: the host wall time per step of both, the device busy
time per step (the sum of kernel times; the idle share is 1 - busy/wall),
the time of each hand-written kernel, and the 25 kernels taking the most
device time.  Needs a CUDA device.
"""

from __future__ import annotations

import time

import torch

N, NZ, N_SPLIT, DT, STEPS = 48, 79, 2, 450.0, 3


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(N, NZ)
    gd = generate_grid_data(N, NZ, device="cuda", dtype=torch.float32)
    config = DynamicalCoreConfig(do_sat_adj=False, n_split=N_SPLIT)
    core = DynamicalCore(config, sizing, gd, timestep=DT)
    state = init_baroclinic_state(sizing, device="cuda", dtype=torch.float32)
    for _ in range(2):
        state = core.step_dynamics(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = core.step_dynamics(state)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = core.step_dynamics(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS

    # device-side events (kernels, copies, fills) carry the device time
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in device) / 1e3 / STEPS
    print(f"C{N}/{NZ} f32 k_split=1 n_split={N_SPLIT}: "
          f"{wall * 1e3:.3f} ms/step wall (profiled), device busy "
          f"{busy:.3f} ms/step, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(e.count for e in device) / STEPS:.0f} device events/step")
    print(f"  unprofiled: {unprofiled:.3f} ms/step wall over the {STEPS} "
          f"steps before the profiled ones; estimated idle share "
          f"{1 - busy / unprofiled:.3f} (their wall, the profiled busy time)")
    ours = ("transport_kernel", "sim1_kernel", "fillz_kernel")
    for e in sorted(device, key=lambda e: -e.device_time_total):
        if any(name in e.key for name in ours):
            print(f"  hand-written {e.key[:90]}: {e.count / STEPS:.0f}"
                  f" launches/step, "
                  f"{e.device_time_total / 1e3 / STEPS:.3f} ms/step")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25, max_name_column_width=70))


if __name__ == "__main__":
    main()
