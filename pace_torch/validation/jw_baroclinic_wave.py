"""Jablonowski & Williamson (2006) baroclinic wave: the nine-day
validation run of the port.

The canonical deterministic dycore test: a 1 m/s zonal-wind perturbation
at (20E, 40N) on a balanced zonal state amplifies through baroclinic
instability — the surface-pressure minimum stays near 1000 hPa until day
~4 and then deepens explosively, to ~960-970 hPa by day 9 at medium
resolution (JW06 Figs. 6-8).  The configuration of the reference package's
examples/validation/jw_baroclinic_wave.py: C24/79 float32, dt=300 s,
k_split=1, n_split=4, no saturation adjustment.

Run on the card:  python -m pace_torch.validation.jw_baroclinic_wave [days]
    [--out PATH] [--device cuda|cpu]

It prints one line a day and writes a JSON record in the layout of
tests/golden/jw_day9.json (config, platform, one entry a day with ps_min,
ps_max, max |va| and the position of the surface-pressure minimum), with
the device's name and, on a card, its name and power limit as nvidia-smi
reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

N, NZ, DT = 24, 79, 300.0


def day_record(day: int, ps, va, lon, lat) -> dict:
    """The record of one day from compute-domain numpy arrays: ps (Pa), va
    (m/s), and the cell-centre longitudes and latitudes (radians)."""
    at = np.unravel_index(np.argmin(ps), ps.shape)
    return {
        "day": day,
        "ps_min_hpa": round(float(ps.min()) / 100.0, 3),
        "ps_max_hpa": round(float(ps.max()) / 100.0, 3),
        "max_abs_va": round(float(np.abs(va).max()), 3),
        "ps_min_lon_deg": round(float(np.degrees(lon[at])), 2),
        "ps_min_lat_deg": round(float(np.degrees(lat[at])), 2),
    }


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(days: int = 9, device="cuda") -> dict:
    """Step the wave `days` simulated days; returns the JSON record."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    device = torch.device(device)
    sizing = GridSizing(N, NZ)
    gd = generate_grid_data(N, NZ, device=device, dtype=torch.float32)
    config = DynamicalCoreConfig(do_sat_adj=False, k_split=1, n_split=4)
    core = DynamicalCore(config, sizing, gd, timestep=DT)
    state = init_baroclinic_state(sizing, device=device, dtype=torch.float32)
    h = sizing.halo
    c = (slice(None), slice(h, h + N), slice(h, h + N))
    lon = gd.horizontal.lon_agrid[c].cpu().numpy()
    lat = gd.horizontal.lat_agrid[c].cpu().numpy()
    steps_per_day = int(86400 / DT)
    record = {
        "config": {"n": N, "nz": NZ, "dt": DT, "n_split": 4, "k_split": 1,
                   "dtype": "float32"},
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "days": [],
        "wall_s": [],
    }
    for day in range(1, days + 1):
        t0 = time.perf_counter()
        for _ in range(steps_per_day):
            state = core.step_dynamics(state)
        ps = state.ps[c].cpu().numpy()
        va = state.va[c].cpu().numpy()
        wall = time.perf_counter() - t0
        if not (np.isfinite(ps).all() and np.isfinite(va).all()):
            raise FloatingPointError(f"day {day}: non-finite ps or va")
        rec = day_record(day, ps, va, lon, lat)
        record["days"].append(rec)
        record["wall_s"].append(wall)
        print(f"day {day}: ps_min {rec['ps_min_hpa']} hPa, ps_max "
              f"{rec['ps_max_hpa']} hPa, max|va| {rec['max_abs_va']} m/s, "
              f"minimum at ({rec['ps_min_lon_deg']}E, "
              f"{rec['ps_min_lat_deg']}N), wall {wall:.3f} s", flush=True)
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("days", nargs="?", type=int, default=9)
    parser.add_argument("--out", default="jw_baroclinic_wave.json",
                        help="where to write the JSON record")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    record = run(args.days, args.device)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out} ({record['device']}; {record['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
