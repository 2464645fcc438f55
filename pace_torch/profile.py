"""Device-time breakdown of the main path and of the coupled step on one GPU.

    python -m pace_torch.profile

Two fixed runs, C48/79 float32, k_split=1, n_split=2:
1. the dycore step (`DynamicalCore.step_dynamics`, do_sat_adj off, dt=450 s);
2. the coupled step behind `pace_torch.driver.Driver` (dt=225 s, do_sat_adj,
   fv_sg_adj=3600, n_sponge=48, GFDL microphysics with mp_time=225), and
   its physics half alone (dry convective adjustment, DycoreToPhysics,
   Physics, UpdateAtmosphereState) on the state the run ends with, and of
   that half the dry convective adjustment alone.
Each runs 3 unprofiled steps and then 3 under torch.profiler, after two
warm-up steps, and prints: the host wall time per step of both, the device
busy time per step (the sum of kernel times; the idle share is
1 - busy/wall), the device events per step, the time of each hand-written
kernel, and the 25 kernels taking the most device time.  Needs a CUDA
device.
"""

from __future__ import annotations

import time

import torch

N, NZ, N_SPLIT, STEPS = 48, 79, 2, 3
OURS = ("transport_kernel", "sim1_kernel", "fillz_kernel")


def profile_steps(label: str, step, state, top: int = 25):
    """Time STEPS calls of state = step(state) unprofiled and STEPS under
    the profiler, and print the breakdown.  Returns the last state."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = step(state)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = step(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS

    # device-side events (kernels, copies, fills) carry the device time
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in device) / 1e3 / STEPS
    print(f"{label}: "
          f"{wall * 1e3:.3f} ms/step wall (profiled), device busy "
          f"{busy:.3f} ms/step, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(e.count for e in device) / STEPS:.0f} device events/step")
    print(f"  unprofiled: {unprofiled:.3f} ms/step wall over the {STEPS} "
          f"steps before the profiled ones; estimated idle share "
          f"{1 - busy / unprofiled:.3f} (their wall, the profiled busy time)")
    for e in sorted(device, key=lambda e: -e.device_time_total):
        if any(name in e.key for name in OURS):
            print(f"  hand-written {e.key[:90]}: {e.count / STEPS:.0f}"
                  f" launches/step, "
                  f"{e.device_time_total / 1e3 / STEPS:.3f} ms/step")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=top, max_name_column_width=70))
    return state


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")

    import dataclasses

    from pace_torch.driver import Driver
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.ops.fv_subgridz import dry_convective_adjustment
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(N, NZ)
    gd = generate_grid_data(N, NZ, device="cuda", dtype=torch.float32)
    config = DynamicalCoreConfig(do_sat_adj=False, n_split=N_SPLIT)
    core = DynamicalCore(config, sizing, gd, timestep=450.0)
    state = init_baroclinic_state(sizing, device="cuda", dtype=torch.float32)
    profile_steps(f"C{N}/{NZ} f32 k_split=1 n_split={N_SPLIT}",
                  core.step_dynamics, state)

    driver = Driver.from_dict(dict(
        nx_tile=N, nz=NZ, dt_atmos=225, dtype="float32",
        initialization={"type": "baroclinic"},
        dycore_config=dict(k_split=1, n_split=N_SPLIT, do_sat_adj=True,
                           fv_sg_adj=3600, n_sponge=48),
        physics_config=dict(dt_atmos=225, mp_time=225)))
    label = (f"coupled C{N}/{NZ} f32 k_split=1 n_split={N_SPLIT} do_sat_adj "
             f"fv_sg_adj=3600 gfdl")
    state = profile_steps(
        label, lambda s: driver.physics_step(driver.dycore.step_dynamics(s)),
        driver.state.dycore_state)
    after_dycore = driver.dycore.step_dynamics(state)
    profile_steps(label + ", physics half alone",
                  lambda s: driver.physics_step(after_dycore), after_dycore,
                  top=15)
    fields = {f.name: getattr(after_dycore, f.name)
              for f in dataclasses.fields(after_dycore)}
    cfg = driver.config.dycore_config

    def adjustment(s):
        dry_convective_adjustment(
            fields, driver.config.dt_atmos, cfg.fv_sg_adj, cfg.n_sponge,
            nwat=cfg.nwat, ptop=driver._ptop)
        return s

    profile_steps(label + ", dry convective adjustment alone", adjustment,
                  after_dycore, top=10)


if __name__ == "__main__":
    main()
