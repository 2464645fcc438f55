"""The nine-day Jablonowski & Williamson baroclinic wave of both packages,
day by day, at float64 and float32 (C24/79, dt 300 s, k_split 1, n_split 4,
no saturation adjustment: scripts/jw_regression.py's configuration).

Committed records under pace_torch/validation/:
- jw_nine_day_h100_f64.json and jw_day9_h100.json (float32): the port on
  an NVIDIA H100, nine days each, written by `python -m
  pace_torch.validation.jw_baroclinic_wave 9 --dtype float64|float32`;
- jw_nine_day_h100_f64_ulp_noise.json: the port's float64 run on the
  card from its initial state moved by at most one ulp a value
  (`--ulp-noise 1`), for the days a call's time limit let it reach: how
  far round-off at the start alone moves the run;
- jw_nine_day_jax_cpu_f64.json and jw_nine_day_jax_cpu_f32.json: pace_tpu
  on a CPU, written by this file's generator (below; the float64 run
  with its six tiles on six CPU devices, the float32 record's one day
  before the generator placed them so), for the days it reached before
  it was stopped: a C24 step of pace_tpu takes over ten seconds on a
  CPU, a simulated day more than an hour;
- jw_day9_same_state_f64.json: both packages on a CPU at float64 from one
  developed state, by the generator's `--from-state`: the port's float32
  day-9 state (`jw_baroclinic_wave --state-out`) read as float64 and
  stepped six times by pace_tpu, so that no float32 quantisation
  is left in it; then every operator of both packages on identical
  inputs, and two steps of both beside the port's steps from the same
  start moved by one ulp.

Each day holds ps_min, ps_max, max |va| and the minimum's position
unrounded (`full`), and the sum, sum of squares and max |x| of ps, pt,
delp, u, v and w on the compute domain (`digest`).  The tests hold the
port's float64 run to the reference's on every day the reference reached,
both packages' operators and steps from one developed state to each
other, and the port's float32 run to its float64 run within the gap
measured between them.

Generator (the reference's trajectory, pace_tpu on the CPU; the record is
rewritten after every day):

    JAX_PLATFORMS=cpu python tests/test_torch_jw_nine_day.py float64 \\
        --out jw_nine_day_jax_cpu_f64.json [--days 9]
    JAX_PLATFORMS=cpu python tests/test_torch_jw_nine_day.py float64 \\
        --from-state day9.npz --out jw_day9_same_state_f64.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pace_torch.validation import jw_baroclinic_wave as jw  # noqa: E402

VALIDATION = os.path.join(ROOT, "pace_torch", "validation")
RECORDS = {
    "jax_cpu_f64": "jw_nine_day_jax_cpu_f64.json",
    "jax_cpu_f32": "jw_nine_day_jax_cpu_f32.json",
    "port_h100_f64": "jw_nine_day_h100_f64.json",
    "port_h100_f32": "jw_day9_h100.json",
    "port_h100_noise_f64": "jw_nine_day_h100_f64_ulp_noise.json",
}
SAME_STATE = "jw_day9_same_state_f64.json"
DAYS = list(range(1, 10))
# The bars of the float64 comparison: ps_min in hPa, max |va| in m/s on
# every day, and the day-1 digests relative to the larger magnitude.
PS_BAR, VA_BAR, DIGEST_BAR = 1e-3, 1e-3, 1e-8
# The reference's mesh on the CPU: (tile, x, y).
TILE_LAYOUT = (6, 1, 1)


def load(name: str) -> dict:
    with open(os.path.join(VALIDATION, name)) as f:
        return json.load(f)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


@pytest.fixture(scope="module")
def records():
    return {key: load(name) for key, name in RECORDS.items()}


# The days each record holds.  The reference's CPU runs stop where their
# generator was stopped (a C24 day of pace_tpu takes over an hour on a
# CPU): a record that lost a day, or one committed further, fails here
# until this table says so.
RECORD_DAYS = {"jax_cpu_f64": 5, "jax_cpu_f32": 1,
               "port_h100_f64": 9, "port_h100_f32": 9,
               "port_h100_noise_f64": 7}


@pytest.mark.parametrize("key", sorted(RECORDS))
def test_record_holds_the_runs_days(records, key):
    rec = records[key]
    dtype = "float64" if key.endswith("f64") else "float32"
    assert rec["config"] == jw.config(dtype)
    assert [d["day"] for d in rec["days"]] == DAYS[:RECORD_DAYS[key]]
    for day in rec["days"]:
        assert set(day["digest"]) == set(jw.DIGEST_FIELDS)
        assert day["full"]["ps_min_hpa"] <= day["full"]["ps_max_hpa"]
    if key.startswith("jax"):
        assert rec["made_by"] == "pace_tpu" and rec["platform"] == "cpu"
        assert rec["jax"] and rec["commit"] and rec["fused_dsw"] is False
    else:
        assert rec["made_by"] == "pace_torch" and rec["platform"] == "gpu"
        assert "H100" in rec["device"] and "W" in rec["card"]
        assert rec.get("ulp_noise") == (1 if "noise" in key else None)


def test_float64_runs_agree_on_every_day_the_reference_reached(records):
    """The port's float64 run on the card against the reference's on the
    CPU, within the bars, with the minimum at the same cell."""
    port = records["port_h100_f64"]["days"]
    for ref in records["jax_cpu_f64"]["days"]:
        want, got = ref["full"], port[ref["day"] - 1]["full"]
        assert abs(got["ps_min_hpa"] - want["ps_min_hpa"]) < PS_BAR, ref
        assert abs(got["max_abs_va"] - want["max_abs_va"]) < VA_BAR, ref
        assert got["ps_min_at"] == want["ps_min_at"]


def test_float64_day1_digests_agree(records):
    ref = records["jax_cpu_f64"]["days"][0]["digest"]
    got = records["port_h100_f64"]["days"][0]["digest"]
    worst = {name: max(rel(a, b) for a, b in zip(ref[name], got[name]))
             for name in jw.DIGEST_FIELDS}
    assert max(worst.values()) < DIGEST_BAR, worst


# The port's float32 run lies at most 0.0133 hPa from its float64 run (day
# 8 of the two nine-day runs on one NVIDIA H100 80GB HBM3 at 700.00 W); the
# bar leaves room above that measurement.
F32_GAP_HPA = 0.03
# The TPU's own float32 spread: its fused and unfused d_sw transports reach
# day 9 at 960.94 and 960.29 hPa (docs/KNOWN_ISSUES.md, "RESOLVED (round
# 5)").  Only the TPU record is placed against it.
TPU_F32_SPREAD_HPA = 0.65


def test_float32_run_lies_within_the_measured_float32_gap(records):
    f64 = records["port_h100_f64"]["days"]
    for day, rec in zip(f64, records["port_h100_f32"]["days"]):
        got, want = rec["full"], day["full"]
        assert abs(got["ps_min_hpa"] - want["ps_min_hpa"]) < F32_GAP_HPA
        assert got["ps_min_at"] == want["ps_min_at"]


def test_the_references_float32_day1_is_the_ports_not_the_tpus(records):
    """pace_tpu's own float32 run on a CPU lies 1.7e-5 hPa from the
    float64 runs on day 1, as the port's float32 run (2.2e-4) does; the TPU
    record lies 0.0132 hPa away."""
    with open(os.path.join(ROOT, "tests", "golden", "jw_day9.json")) as f:
        tpu = json.load(f)["days"][0]["ps_min_hpa"]
    for f64_key in ("jax_cpu_f64", "port_h100_f64"):
        f64 = records[f64_key]["days"][0]["full"]["ps_min_hpa"]
        for key in ("jax_cpu_f32", "port_h100_f32"):
            f32 = records[key]["days"][0]["full"]["ps_min_hpa"]
            assert abs(f32 - f64) < 1e-3 < 0.01 < abs(tpu - f64), key


def test_the_tpu_record_leaves_the_ports_float64_run():
    """tests/golden/jw_day9.json (float32, `"platform": "tpu"`) against the
    port's float64 run: 0.0132 hPa apart on day 1, further apart than the
    TPU's own float32 spread from day 6, 12.43 hPa on day 9.  Past the
    days the reference's float64 run reached, the port's stands in for
    it, which this test does not settle."""
    with open(os.path.join(ROOT, "tests", "golden", "jw_day9.json")) as f:
        tpu = json.load(f)
    f64 = load(RECORDS["port_h100_f64"])["days"]
    gaps = [day["full"]["ps_min_hpa"] - rec["ps_min_hpa"]
            for day, rec in zip(f64, tpu["days"])]
    assert 0.01 < gaps[0] < TPU_F32_SPREAD_HPA < gaps[5] < gaps[8]
    assert gaps[8] > 12.0


# Every operator of the two packages on identical float64 inputs from one
# developed state, within this fraction of each output's max |x|.
OPERATOR_BAR = 1e-12
# The two packages' steps from one state, within this multiple of the
# port's own distance from a one-ulp-noised start.
ROUND_OFF_MULTIPLE = 3.0
# The one-state comparison: the reference's steps from the saved state
# before it starts, and the steps both packages then take.
SETTLE_STEPS, SAME_STATE_STEPS = 6, 2


def test_every_operator_agrees_on_a_developed_state():
    rec = load(SAME_STATE)
    assert rec["config"] == jw.config("float64")
    ops = {key.split()[0] for key in rec["operators"]}
    assert {"column_namelist", "vertical_params", "c_sw", "fx_adv",
            "fv_tp_2d", "x_flux", "d_sw", "update_dz_c", "riem_solver_c",
            "p_grad_c", "update_dz_d", "riem_solver3", "nh_p_grad",
            "a2b_ord4", "del2_cubed", "tracer_advection", "remapping",
            "c2l_ord4"} == ops
    worst = max(rec["operators"].items(), key=lambda item: item[1])
    assert worst[1] < OPERATOR_BAR, worst


def test_one_state_steps_differ_only_as_round_off_moves_them():
    """From one developed float64 state the packages' steps part no
    further than the port's own step moves when every value of its start
    moves by one ulp."""
    rec = load(SAME_STATE)
    assert rec["settle_steps"] == SETTLE_STEPS
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    for step in rec["steps"]:
        assert step["port"]["step"] == step["jax"]["step"] == step["step"]
        for name, diff in step["max_diff_over_scale"].items():
            assert diff <= ROUND_OFF_MULTIPLE * step[
                "ulp_noise_over_scale"][name], (step["step"], name)
        assert step["port"]["full"]["ps_min_at"] == \
            step["jax"]["full"]["ps_min_at"]


@pytest.mark.slow
def test_reference_day1_is_the_records(tmp_path):
    """The generator's day 1 (a C24 float64 day of pace_tpu on six CPU
    devices, more than an hour) is the committed record's day 1,
    exactly."""
    want = load(RECORDS["jax_cpu_f64"])["days"][0]
    got = _generate("float64", 1, str(tmp_path / "day1.json"))["days"][0]
    assert got["full"] == want["full"] and got["digest"] == want["digest"]


def _jax(dtype_name: str):
    """jax with its compilation cache (scripts/jw_regression.py's), in
    float64 where asked."""
    import jax

    cache_dir = os.environ.get(
        "PACE_XLA_CACHE", os.path.expanduser("~/.cache/pace_tpu_xla"))
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)
    return jax


def _generate(dtype_name: str, days: int, out: str) -> dict:
    """scripts/jw_regression.py's run (lines 43-88) at `dtype_name`, each
    day recorded as the port's run records it; `out` is rewritten after
    every day."""
    jax = _jax(dtype_name)
    import jax.numpy as jnp
    import numpy as np

    from pace_tpu.grid.generation import generate_grid_data
    from pace_tpu.models.fv3.config import DynamicalCoreConfig
    from pace_tpu.models.fv3.dynamics import DynamicalCore
    from pace_tpu.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_tpu.ops.pallas import fvtp2d_pallas
    from pace_tpu.utils.gridtools import GridSizing

    from jax.sharding import NamedSharding, PartitionSpec as P

    from pace_tpu.driver.driver import MeshConfig

    dtype = getattr(jnp, dtype_name)
    sizing = GridSizing(jw.N, jw.NZ)
    gd = generate_grid_data(jw.N, jw.NZ, dtype=dtype)
    cfg = DynamicalCoreConfig(do_sat_adj=False, k_split=1, n_split=4)
    core = DynamicalCore(cfg, sizing, gd, timestep=jw.DT)
    state = init_baroclinic_state(sizing, dtype=dtype)
    steps_per_day = int(86400 / jw.DT)
    # One tile on each of six CPU devices, placed as pace_tpu's Driver
    # places a (6, 1, 1) mesh: the tiles step in parallel.
    mesh = MeshConfig(layout=TILE_LAYOUT).build()

    def shard(leaf):
        spec = (P("tile", "x", "y") if leaf.ndim >= 3
                else P("tile") if leaf.ndim >= 1 else P())
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    state = jax.tree_util.tree_map(shard, state)

    def run_day(s):
        return jax.lax.fori_loop(
            0, steps_per_day, lambda i, x: core.step_dynamics(x), s)

    run_day_jit = jax.jit(run_day, donate_argnums=0)
    lon = jw.compute("lon", np.asarray(gd.horizontal.lon_agrid))
    lat = jw.compute("lat", np.asarray(gd.horizontal.lat_agrid))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    record = {
        "config": jw.config(dtype_name),
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "made_by": "pace_tpu",
        "jax": jax.__version__,
        "commit": commit,
        "fused_dsw": fvtp2d_pallas.fused_dsw_enabled(dtype, cfg.n_split),
        "mesh_layout": list(TILE_LAYOUT),
        "days": [],
        "wall_s": [],
    }
    for day in range(1, days + 1):
        t0 = time.perf_counter()
        state = run_day_jit(state)
        fields = {name: jw.compute(name, np.asarray(getattr(state, name)))
                  for name in jw.DIGEST_FIELDS + ("va",)}
        wall = time.perf_counter() - t0
        rec = jw.day_record(day, fields["ps"], fields["va"], lon, lat,
                            fields)
        record["days"].append(rec)
        record["wall_s"].append(wall)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        full = rec["full"]
        print(f"day {day}: ps_min {full['ps_min_hpa']!r} hPa, max|va| "
              f"{full['max_abs_va']!r} m/s, wall {wall:.0f} s", flush=True)
    return record


def _operators(rcore, core, arrays: dict) -> dict:
    """Every dycore operator of both packages on identical float64 inputs:
    the reference's halo-updated fields of the state `arrays`, and the
    reference's outputs of the operators before (as
    tests/golden/op_suite.py feeds them).  Returns, for each operator
    output, the largest difference on the compute domain over the
    reference's max |x| there."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pace_torch.models.fv3.acoustics import _p_grad_c
    from pace_torch.models.fv3.state import NQ, TRACER_NAMES
    from pace_torch.ops import (c_sw, d_sw, del2cubed, fxadv, nh_p_grad,
                                remapping, riemann, tracer_advection,
                                updatedz, updatedzd)
    from pace_torch.ops.a2b_ord4 import a2b_ord4
    from pace_torch.ops.c2l_ord import cubed_to_latlon
    from pace_torch.ops.fvtp2d import fv_tp_2d
    from pace_torch.ops.xppm import x_flux
    from pace_torch.utils import constants
    from pace_tpu.models.fv3.acoustics import _p_grad_c as r_p_grad_c
    from pace_tpu.models.fv3.state import NQ as RNQ
    from pace_tpu.models.fv3.state import TRACER_NAMES as RTN
    from pace_tpu.ops import c_sw as r_c_sw
    from pace_tpu.ops import d_sw as r_d_sw
    from pace_tpu.ops import del2cubed as r_del2
    from pace_tpu.ops import fxadv as r_fx
    from pace_tpu.ops import nh_p_grad as r_nh
    from pace_tpu.ops import remapping as r_remap
    from pace_tpu.ops import riemann as r_rm
    from pace_tpu.ops import tracer_advection as r_tr
    from pace_tpu.ops import updatedz as r_udz
    from pace_tpu.ops import updatedzd as r_udzd
    from pace_tpu.ops.a2b_ord4 import a2b_ord4 as r_a2b
    from pace_tpu.ops.c2l_ord import cubed_to_latlon as r_c2l
    from pace_tpu.ops.fvtp2d import fv_tp_2d as r_fvtp
    from pace_tpu.ops.xppm import x_flux as r_xflux
    from pace_tpu.parallel import halo as rhalo
    from pace_tpu.utils import constants as rcon

    n, h, nz = jw.N, jw.H, jw.NZ
    rgd, gd = rcore.grid_data, core.grid_data
    dom, topo = core.topo.domain, rcore.topo
    cfg, rcfg = core.config, rcore.config
    col, rcol = core.column_namelist, rcore.column_namelist
    vp, rvp = core.vertical_params, rcore.vertical_params
    dt_ac = jw.DT / cfg.n_split
    dt2 = dt_ac / 2
    diff = {}

    def over_scale(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.nanmax(np.abs(b - a)) / (np.nanmax(np.abs(a))
                                                 + 1e-300))

    for key in rcol:
        diff[f"column_namelist {key}"] = over_scale(rcol[key], col[key])
    for key in rvp:
        diff[f"vertical_params {key}"] = over_scale(rvp[key], vp[key])

    s = {k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()}
    center = topo.scalar_spec("center")
    for name in ("delp", "pt", "w", "q_con", "omga"):
        s[name] = rhalo.halo_update_scalar(s[name], center)
    s["u"], s["v"] = rhalo.halo_update_vector(topo, s["u"], s["v"],
                                              "y_iface", "x_iface")
    s["uc"], s["vc"] = rhalo.halo_update_vector(topo, s["uc"], s["vc"],
                                                "x_iface", "y_iface")

    def T(a):
        return torch.tensor(np.asarray(a))

    ts = {k: T(v) for k, v in s.items()}
    window = (slice(None), slice(h, h + n + 1), slice(h, h + n + 1))

    def cmp(op, names, ref, got):
        for name, r, g in zip(names, ref, got):
            r = np.asarray(r, np.float64)[window]
            g = (g.numpy() if isinstance(g, torch.Tensor)
                 else np.asarray(g))[window]
            assert (np.isnan(g) == np.isnan(r)).all(), (op, name)
            diff[f"{op} {name}"] = over_scale(r, g)

    rcsw = r_c_sw.c_sw(s["delp"], s["pt"], s["u"], s["v"], s["w"],
                       s["omga"], rgd, n, h, dt2, rcfg.nord)
    csw = c_sw.c_sw(ts["delp"], ts["pt"], ts["u"], ts["v"], ts["w"],
                    ts["omga"], gd, dom, dt2, cfg.nord)
    cmp("c_sw", ["delpc", "ptc", "uc", "vc", "ua", "va", "ut", "vt",
                 "divgd", "omga"], rcsw[:10], csw[:10])
    tcsw = [T(a) for a in rcsw]

    rz, tz = jnp.zeros_like(s["delp"]), torch.zeros_like(ts["delp"])
    rfx = r_fx.fx_adv(s["uc"], s["vc"], rz, rz, rgd, n, h, dt_ac)
    fx = fxadv.fx_adv(ts["uc"], ts["vc"], tz, tz, gd, dom, dt_ac)
    cmp("fx_adv", ["crx", "cry", "xfx", "yfx", "ut", "vt"], rfx, fx)
    crx, cry, xfx, yfx, ut, vt = [T(a) for a in rfx]
    rcrx, rcry, rxfx, ryfx, rut, rvt = rfx

    for hord in (5, 6, 8, 10):
        cmp(f"fv_tp_2d hord {hord}", ["fx", "fy"],
            r_fvtp(s["delp"], rcrx, rcry, rxfx, ryfx, rgd, n, h, hord,
                   nord_col=rcol["nord_v"], damp_c_col=rcol["damp_vt"]),
            fv_tp_2d(ts["delp"], crx, cry, xfx, yfx, gd, dom, hord,
                     nord_col=col["nord_v"], damp_c_col=col["damp_vt"]))
        cmp(f"x_flux ord {hord}", ["flux"],
            [r_xflux(s["pt"], rcrx, rgd.horizontal.dxa[..., None], n, h,
                     hord)],
            [x_flux(ts["pt"], crx, gd.horizontal.dxa[..., None], dom,
                    hord)])

    rdsw = r_d_sw.d_sw(
        s["delp"], s["pt"], s["u"], s["v"], s["w"], s["uc"], s["vc"],
        s["ua"], s["va"], rcsw[8], s["mfxd"], s["mfyd"], s["cxd"],
        s["cyd"], s["q_con"], rz, s["diss_estd"], rut, rvt, rgd, rcol,
        rcfg, n, h, dt_ac)
    dsw = d_sw.d_sw(
        ts["delp"], ts["pt"], ts["u"], ts["v"], ts["w"], ts["uc"],
        ts["vc"], ts["ua"], ts["va"], tcsw[8], ts["mfxd"], ts["mfyd"],
        ts["cxd"], ts["cyd"], ts["q_con"], tz, ts["diss_estd"], ut, vt,
        gd, col, cfg, dom, dt_ac)
    names = ["delp", "pt", "u", "v", "w", "q_con", "divgd", "delpc", "mfx",
             "mfy", "heat_source"]
    cmp("d_sw", names, [rdsw[k] for k in names], [dsw[k] for k in names])

    zs_r = s["phis"] * rcon.RGRAV
    below = jnp.cumsum(s["delz"][..., ::-1], -1)[..., ::-1]
    gz_r = jnp.concatenate([zs_r[..., None] - below, zs_r[..., None]], -1)
    zs_t, gz_t = T(zs_r), T(gz_r)
    rgzc, rws3 = r_udz.update_dz_c(
        jnp.asarray(rvp["dp_ref"], gz_r.dtype), zs_r, rgd.horizontal.area,
        rcsw[6], rcsw[7], gz_r, n, h, dt2)
    gzc, ws3 = updatedz.update_dz_c(
        torch.as_tensor(np.asarray(vp["dp_ref"]), dtype=torch.float64),
        zs_t, gd.horizontal.area, tcsw[6], tcsw[7], gz_t, dom, dt2)
    cmp("update_dz_c", ["gz", "ws3"], [rgzc, rws3], [gzc, ws3])

    cap_r = jnp.full_like(s["delp"], 0.28)
    cap_t = torch.full_like(ts["delp"], 0.28)
    rr = r_rm.riem_solver_c(dt2, cap_r, rgd.vertical.ptop, s["phis"], rws3,
                            rcsw[1], s["q_con"], rcsw[0], rgzc, s["omga"],
                            rcfg.p_fac)
    tr = riemann.riem_solver_c(dt2, cap_t, gd.vertical.ptop, ts["phis"],
                               T(rws3), tcsw[1], ts["q_con"], tcsw[0],
                               T(rgzc), ts["omga"], cfg.p_fac)
    cmp("riem_solver_c", ["gz", "pkc"], rr, tr)
    cmp("p_grad_c", ["uc", "vc"],
        r_p_grad_c(rcsw[2], rcsw[3], rcsw[0], rr[1], rr[0], rgd, dt2,
                   hydrostatic=False),
        _p_grad_c(tcsw[2], tcsw[3], tcsw[0], T(rr[1]), T(rr[0]), gd, dt2))

    rzh, rwsd = r_udzd.update_dz_d(
        zs_r, gz_r[..., :nz + 1], rcrx, rcry, rxfx, ryfx, rgd, rcol, rcfg,
        n, h, dt_ac, rvp["dp_ref"])
    cmp("update_dz_d", ["zh", "wsd"], [rzh, rwsd], updatedzd.update_dz_d(
        zs_t, gz_t[..., :nz + 1], crx, cry, xfx, yfx, gd, col, cfg, dom,
        dt_ac, vp["dp_ref"]))
    r3 = r_rm.riem_solver3(
        dt_ac, cap_r, rgd.vertical.ptop, zs_r, rwsd, s["delz"], s["q_con"],
        s["delp"], s["pt"], rzh, s["pe"], jnp.zeros_like(s["pe"]), s["pk"],
        s["peln"], s["w"], rcfg.p_fac, rcfg.beta, rcfg.use_logp,
        last_call=True)
    t3 = riemann.riem_solver3(
        dt_ac, cap_t, gd.vertical.ptop, zs_t, T(rwsd), ts["delz"],
        ts["q_con"], ts["delp"], ts["pt"], T(rzh), ts["pe"],
        torch.zeros_like(ts["pe"]), ts["pk"], ts["peln"], ts["w"],
        cfg.p_fac, cfg.beta, cfg.use_logp, last_call=True)
    cmp("riem_solver3", ["delz", "zh", "pe", "pkc", "pk3", "pk", "peln",
                         "w"], r3, t3)
    cmp("nh_p_grad", ["u", "v"],
        r_nh.nh_p_grad(s["u"], s["v"], r3[3], r3[1] * rcon.GRAV, r3[4],
                       s["delp"], rgd, n, h, dt_ac, rgd.vertical.ptop,
                       rcon.KAPPA)[:2],
        nh_p_grad.nh_p_grad(ts["u"], ts["v"], T(r3[3]),
                            T(r3[1]) * constants.GRAV, T(r3[4]),
                            ts["delp"], gd, dom, dt_ac, gd.vertical.ptop,
                            constants.KAPPA)[:2])
    cmp("a2b_ord4", ["qb"], [r_a2b(s["pt"], rgd, n, h)],
        [a2b_ord4(ts["pt"], gd, dom)])
    cmp("del2_cubed", ["q"],
        [r_del2.hyperdiffusion(s["omga"], rgd, 0.2, n, h, nmax=2)],
        [del2cubed.hyperdiffusion(ts["omga"], gd, 0.2, dom, nmax=2)])

    radv = r_tr.tracer_advection(
        {k: s[k] for k in RTN[:RNQ]}, s["delp"], s["mfxd"], s["mfyd"],
        s["cxd"], s["cyd"], rgd, topo, n, h, rcfg.hord_tr)
    tadv = tracer_advection.tracer_advection(
        {k: ts[k] for k in TRACER_NAMES[:NQ]}, ts["delp"], ts["mfxd"],
        ts["mfyd"], ts["cxd"], ts["cyd"], gd, core.topo, cfg.hord_tr)
    names = sorted(radv)
    cmp("tracer_advection", names, [radv[k] for k in names],
        [tadv[k] for k in names])

    rrm = r_remap.lagrangian_to_eulerian(
        {k: s[k] for k in r_remap.REMAP_TRACERS}, s["pt"], s["delp"],
        s["delz"], s["peln"], s["u"], s["v"], s["w"], cap_r, s["q_con"],
        s["pkz"], s["pk"], s["pe"], s["phis"], s["ps"],
        jnp.zeros_like(s["ps"]), rgd, rcfg, n, h, True, rcfg.consv_te,
        jw.DT, do_sat_adj_fn=None)
    trm = remapping.lagrangian_to_eulerian(
        {k: ts[k] for k in remapping.REMAP_TRACERS}, ts["pt"], ts["delp"],
        ts["delz"], ts["peln"], ts["u"], ts["v"], ts["w"], cap_t,
        ts["q_con"], ts["pkz"], ts["pk"], ts["pe"], ts["phis"], ts["ps"],
        torch.zeros_like(ts["ps"]), gd, cfg, n, h, True, cfg.consv_te,
        jw.DT)
    names = ["pt", "delp", "delz", "u", "v", "w", "pkz"]
    cmp("remapping", names + ["qvapor"],
        [rrm[k] for k in names] + [rrm["tracers"]["qvapor"]],
        [trm[k] for k in names] + [trm["tracers"]["qvapor"]])
    cmp("c2l_ord4", ["ua", "va"], r_c2l(s["u"], s["v"], rgd, topo, n, h,
                                        order=4)[:2],
        cubed_to_latlon(ts["u"], ts["v"], gd, core.topo, order=4)[:2])
    return diff


def _same_state(npz: str, out: str) -> dict:
    """Both packages on the CPU at float64 from one developed state: the
    padded fields of a DycoreState saved in `npz` (e.g. the port's day-9
    state from `jw_baroclinic_wave --state-out`), stepped first
    SETTLE_STEPS times by the reference alone, so that a float32 state's
    quantisation (exact ties that one-ulp noise flips) is gone from the
    start.  From that start the record holds every operator of both
    packages on identical inputs (`operators`, `_operators`), then
    SAME_STATE_STEPS steps of both: each step's record of both, and the
    largest difference of each digested field on the compute domain over
    the reference's max |x| there.  The port also steps from the start
    with each value moved by at most one unit in the last place (seeded):
    its distance from the port's own steps is the yardstick of the step's
    sensitivity to round-off (`ulp_noise_over_scale`)."""
    jax = _jax("float64")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.utils.gridtools import GridSizing
    from pace_tpu.grid.generation import generate_grid_data as ref_grid
    from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefConfig
    from pace_tpu.models.fv3.dynamics import DynamicalCore as RefCore
    from pace_tpu.models.fv3.state import DycoreState as RefState
    from pace_tpu.utils.gridtools import GridSizing as RefSizing

    ref_core = RefCore(RefConfig(do_sat_adj=False, k_split=1, n_split=4),
                       RefSizing(jw.N, jw.NZ),
                       ref_grid(jw.N, jw.NZ, dtype=jnp.float64),
                       timestep=jw.DT)
    ref_step = jax.jit(ref_core.step_dynamics)
    ref = RefState.from_numpy(dict(np.load(npz)), jnp.float64)
    for _ in range(SETTLE_STEPS):
        ref = ref_step(ref)
    arrays = {name: np.asarray(leaf) for name, leaf in vars(ref).items()}
    gd = generate_grid_data(jw.N, jw.NZ, device="cpu", dtype=torch.float64)
    core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False, k_split=1,
                                             n_split=4),
                         GridSizing(jw.N, jw.NZ), gd, timestep=jw.DT)
    record = {"config": jw.config("float64"), "start": os.path.basename(npz),
              "settle_steps": SETTLE_STEPS, "jax": jax.__version__,
              "torch": torch.__version__,
              "operators": _operators(ref_core, core, arrays), "steps": []}
    port = DycoreState.from_numpy(arrays, "cpu", torch.float64)
    noised = DycoreState.from_numpy(jw.one_ulp_noise(arrays, 0), "cpu",
                                    torch.float64)
    lon = jw.compute("lon", gd.horizontal.lon_agrid.numpy())
    lat = jw.compute("lat", gd.horizontal.lat_agrid.numpy())
    names = jw.DIGEST_FIELDS + ("va",)

    def step_record(step, fields):
        rec = jw.day_record(0, fields["ps"], fields["va"], lon, lat, fields)
        del rec["day"]
        return dict(step=step, **rec)

    def over_scale(a, b):
        return {n: float(np.abs(a[n] - b[n]).max() / np.abs(b[n]).max())
                for n in names}

    for step in range(1, SAME_STATE_STEPS + 1):
        ref = ref_step(ref)
        port = core.step_dynamics(port)
        noised = core.step_dynamics(noised)
        got = {n: jw.compute(n, getattr(port, n).numpy()) for n in names}
        want = {n: jw.compute(n, np.asarray(getattr(ref, n)))
                for n in names}
        near = {n: jw.compute(n, getattr(noised, n).numpy()) for n in names}
        diff = over_scale(got, want)
        record["steps"].append({
            "step": step,
            "port": step_record(step, got),
            "jax": step_record(step, want),
            "max_diff_over_scale": diff,
            "ulp_noise_over_scale": over_scale(near, got),
        })
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"step {step}: {diff}; ulp noise "
              f"{record['steps'][-1]['ulp_noise_over_scale']}", flush=True)
    return record


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="the reference's nine-day trajectory on the CPU, or "
                    "both packages' steps from one saved state")
    parser.add_argument("dtype", choices=("float32", "float64"))
    parser.add_argument("--out", required=True)
    parser.add_argument("--days", type=int, default=9)
    parser.add_argument("--from-state", default=None,
                        help="an .npz state: step both packages from it")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_num_cpu_devices", 6)
    if args.from_state:
        assert args.dtype == "float64", "the one-state steps run at float64"
        _same_state(args.from_state, args.out)
    else:
        _generate(args.dtype, args.days, args.out)
