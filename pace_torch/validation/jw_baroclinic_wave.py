"""Jablonowski & Williamson (2006) baroclinic wave: the nine-day
validation run of the port.

The canonical deterministic dycore test: a 1 m/s zonal-wind perturbation
at (20E, 40N) on a balanced zonal state amplifies through baroclinic
instability — the surface-pressure minimum stays near 1000 hPa until day
~4 and then deepens explosively, to ~960-970 hPa by day 9 at medium
resolution (JW06 Figs. 6-8).  The configuration of the reference package's
examples/validation/jw_baroclinic_wave.py: C24/79, dt=300 s, k_split=1,
n_split=4, no saturation adjustment; float32 by default, float64 with
`--dtype float64`.

Run on the card:  python -m pace_torch.validation.jw_baroclinic_wave [days]
    [--out PATH] [--device cuda|cpu] [--dtype float32|float64]
    [--state-out NPZ] [--state-in NPZ --start-day D]

It prints one line a day and writes a JSON record in the layout of
tests/golden/jw_day9.json (config, platform, one entry a day with ps_min,
ps_max, max |va| and the position of the surface-pressure minimum, rounded
as there), with the device's name and, on a card, its name and power limit
as nvidia-smi reports them.  Each day also carries the same values
unrounded (`full`) and a digest of ps, pt, delp, u, v and w on the compute
domain (`digest`: sum, sum of squares and max |x|, each in float64).  The
record is rewritten after every day, so a run that is cut keeps the days
it finished.  `--state-in` starts from a state `--state-out` saved, and
`--start-day` numbers the first day run (3 for a day-2 state).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N, NZ, DT, H = 24, 79, 300.0, 3
DIGEST_FIELDS = ("ps", "pt", "delp", "u", "v", "w")
# (interfaces along x, interfaces along y) of the D-grid winds
STAGGER = {"u": (False, True), "v": (True, False)}
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def config(dtype: str) -> dict:
    return {"n": N, "nz": NZ, "dt": DT, "n_split": 4, "k_split": 1,
            "dtype": dtype}


def compute(name: str, a, n: int = N, h: int = H):
    """The compute-domain points of storage array `a` of field `name`."""
    ix, iy = STAGGER.get(name, (False, False))
    return a[:, h:h + n + int(ix), h:h + n + int(iy)]


def field_digest(a) -> list:
    """[sum, sum of squares, max |x|] of numpy array `a`, in float64."""
    a = np.asarray(a, np.float64)
    return [float(a.sum()), float((a * a).sum()), float(np.abs(a).max())]


def day_record(day: int, ps, va, lon, lat, fields: dict | None = None
               ) -> dict:
    """The record of one day from compute-domain numpy arrays: ps (Pa), va
    (m/s), and the cell-centre longitudes and latitudes (radians), rounded
    as tests/golden/jw_day9.json rounds them.  Given `fields` (DIGEST_FIELDS
    on the compute domain), the record also holds the values unrounded
    (`full`) and the fields' digests (`digest`)."""
    at = np.unravel_index(np.argmin(ps), ps.shape)
    full = {
        "ps_min_hpa": float(ps.min()) / 100.0,
        "ps_max_hpa": float(ps.max()) / 100.0,
        "max_abs_va": float(np.abs(va).max()),
        "ps_min_lon_deg": float(np.degrees(lon[at])),
        "ps_min_lat_deg": float(np.degrees(lat[at])),
    }
    rec = {"day": day}
    for key, digits in (("ps_min_hpa", 3), ("ps_max_hpa", 3),
                        ("max_abs_va", 3), ("ps_min_lon_deg", 2),
                        ("ps_min_lat_deg", 2)):
        rec[key] = round(full[key], digits)
    if fields is not None:
        rec["full"] = dict(full, ps_min_at=[int(i) for i in at])
        rec["digest"] = {name: field_digest(fields[name])
                         for name in DIGEST_FIELDS}
    return rec


def one_ulp_noise(arrays: dict, seed: int) -> dict:
    """numpy `arrays` with each value moved by at most one unit in the
    last place, up, down or not at all, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    noised = {}
    for name, a in arrays.items():
        move = rng.integers(-1, 2, a.shape)
        noised[name] = np.where(move > 0, np.nextafter(a, np.inf),
                                np.where(move < 0, np.nextafter(a, -np.inf),
                                         a))
    return noised


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(days: int = 9, device="cuda", dtype: str = "float32",
        out: str | None = None, state_out: str | None = None,
        ulp_noise: int | None = None, state_in: str | None = None,
        start_day: int = 1) -> dict:
    """Step the wave `days` simulated days; returns the JSON record,
    written to `out` after every day if given.
    `state_out` receives the last state's fields (a compressed .npz, the
    padded layout of `DycoreState`).  Given `ulp_noise` (a seed), the run
    starts from the initial state moved by at most one ulp a value
    (`one_ulp_noise`): how far it then parts from the run without noise
    is how far round-off alone moves the run.  Given `state_in` (an .npz
    `state_out` wrote), the run starts from that state instead of the
    initial one; its days are numbered from `start_day`."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.utils.gridtools import GridSizing

    device = torch.device(device)
    tdtype = DTYPES[dtype]
    sizing = GridSizing(N, NZ)
    gd = generate_grid_data(N, NZ, device=device, dtype=tdtype)
    core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False, k_split=1,
                                             n_split=4),
                         sizing, gd, timestep=DT)
    if state_in is None:
        state = init_baroclinic_state(sizing, device=device, dtype=tdtype)
    else:
        state = DycoreState.from_numpy(dict(np.load(state_in)), device,
                                       tdtype)
    if ulp_noise is not None:
        state = DycoreState.from_numpy(one_ulp_noise(
            {f.name: getattr(state, f.name).cpu().numpy()
             for f in dataclasses.fields(state)}, ulp_noise), device, tdtype)
    lon = compute("lon", gd.horizontal.lon_agrid.cpu().numpy())
    lat = compute("lat", gd.horizontal.lat_agrid.cpu().numpy())
    record = {
        "config": config(dtype),
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "made_by": "pace_torch",
        "torch": torch.__version__,
        "ulp_noise": ulp_noise,
        "state_in": None if state_in is None else os.path.basename(state_in),
        "days": [],
        "wall_s": [],
    }
    for day in range(start_day, start_day + days):
        t0 = time.perf_counter()
        for _ in range(int(86400 / DT)):
            state = core.step_dynamics(state)
        fields = {name: compute(name, getattr(state, name).cpu().numpy())
                  for name in DIGEST_FIELDS + ("va",)}
        wall = time.perf_counter() - t0
        if not all(np.isfinite(a).all() for a in fields.values()):
            raise FloatingPointError(f"day {day}: non-finite state")
        rec = day_record(day, fields["ps"], fields["va"], lon, lat, fields)
        record["days"].append(rec)
        record["wall_s"].append(wall)
        if out is not None:
            with open(out, "w") as f:
                json.dump(record, f, indent=1)
        full = rec["full"]
        print(f"day {day}: ps_min {full['ps_min_hpa']!r} hPa, ps_max "
              f"{full['ps_max_hpa']!r} hPa, max|va| {full['max_abs_va']!r} "
              f"m/s, minimum at ({rec['ps_min_lon_deg']}E, "
              f"{rec['ps_min_lat_deg']}N), wall {wall:.3f} s", flush=True)
    if state_out is not None:
        np.savez_compressed(state_out, **{
            f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)})
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("days", nargs="?", type=int, default=9)
    parser.add_argument("--out", default="jw_baroclinic_wave.json",
                        help="where to write the JSON record")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    parser.add_argument("--state-out", default=None,
                        help="an .npz for the last day's state")
    parser.add_argument("--ulp-noise", type=int, default=None,
                        metavar="SEED",
                        help="start from the initial state moved by at most "
                             "one ulp a value")
    parser.add_argument("--state-in", default=None,
                        help="an .npz of --state-out to start from")
    parser.add_argument("--start-day", type=int, default=1,
                        help="the number of the first day run (3 from a "
                             "day-2 state)")
    args = parser.parse_args(argv)
    record = run(args.days, args.device, dtype=args.dtype, out=args.out,
                 state_out=args.state_out, ulp_noise=args.ulp_noise,
                 state_in=args.state_in, start_day=args.start_day)
    print(f"wrote {args.out} ({record['device']}; {record['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
