"""The port's C12/79 dycore step (pace_torch, plain versions on the CPU)
against the reference package's committed outputs, without running JAX:

- float64 steps 1 and 4 against tests/golden/c12_dycore_digest.json at the
  1e-9 bar of tests/test_golden.py;
- float32 steps 1 and 2 against c12_dycore_digest_f32.json at 1e-3 of
  field scale.  At step 2 float32 rounding alone moves omga, w and
  diss_estd by about that much: the reference's own float32 run lies
  1.63e-2, 2.45e-3 and 3.93e-3 from the float64 run, and a one-ulp nudge
  of the initial pt moves the port's omga and w by 1.15e-3.  A field
  past the bar passes when its own error against the float64 run is at
  most 1.5x the reference's (the port's is 1.05x, 0.80x and 0.83x);
- the 16 operator digests of c12_op_digest.json at 1e-9
  (tests/test_op_golden.py), the operators applied to the port's step-1
  state exactly as tests/golden/op_suite.py applies them.  One field,
  p_grad_c.uc, is held at 2e-9: op_suite builds gz from delz without a
  halo update, so the west-edge column of p_grad_c reads halo cells of the
  step-1 state that no step output defines (the two packages' delz there
  differ by up to 7.8e-3 relative); the measured digest error is
  1.12e-9.  `test_p_grad_c_matches_reference_on_same_inputs` pins the
  operator itself at 1e-12.
Together these hold every module of the slice against the reference."""

import json
import os

import numpy as np
import pytest
import torch

from pace_torch.testing import c12_dycore_run, digest_errors
from pace_torch.testing import state_digest as port_state_digest
from tests.golden.make_golden import state_digest
from tests.golden.op_suite import digest as op_digest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N_, NZ, H, DT = 12, 79, 3, 225.0


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _run(dtype, nsteps):
    sizing, core, states = c12_dycore_run(dtype, nsteps)
    return sizing, core, states[1:]


@pytest.fixture(scope="module")
def runs():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        f64 = _run(torch.float64, 4)
        f32 = _run(torch.float32, 2)
    finally:
        torch.set_num_threads(old)
    return f64, f32


def _assert_digest(got, ref, tol, label):
    for name, r in ref.items():
        g = got[name]
        scale = max(abs(r["max"]), abs(r["min"]), 1e-30)
        for stat in ("mean", "std", "min", "max"):
            assert abs(g[stat] - r[stat]) <= tol * scale, (
                f"{label}.{name}.{stat}: {g[stat]} != {r[stat]}")
        np.testing.assert_allclose(g["samples"], r["samples"], rtol=tol,
                                   atol=tol * scale,
                                   err_msg=f"{label}.{name}.samples")


def test_c12_f64_matches_reference_digest(runs):
    (sizing, _, states), _ = runs
    golden = _load("c12_dycore_digest.json")
    for i in (1, 4):
        _assert_digest(state_digest(states[i - 1], sizing),
                       golden[f"step{i}"], 1e-9, f"step{i}")


def test_port_state_digest_matches_golden_digest(runs):
    """chip_smoke.py digests the card's state with pace_torch.testing's
    copy of make_golden.state_digest; the two must agree exactly."""
    (sizing, _, states), (_, _, states32) = runs
    for state in (states[0], states32[0]):
        assert port_state_digest(state, sizing) == state_digest(state, sizing)


def test_c12_f32_matches_reference_digest(runs):
    (sizing, _, truth), (_, _, states) = runs
    golden = _load("c12_dycore_digest_f32.json")
    _assert_digest(state_digest(states[0], sizing), golden["step1"], 1e-3,
                   "step1")
    got = state_digest(states[1], sizing)
    ref = golden["step2"]
    truth = state_digest(truth[1], sizing)
    err_ref = digest_errors(got, ref)
    err_truth = digest_errors(got, truth)
    ref_truth = digest_errors(ref, truth)
    bad = {name: (e, err_truth[name], ref_truth[name])
           for name, e in err_ref.items()
           if e > 1e-3 and err_truth[name] > 1.5 * ref_truth[name]}
    assert not bad, bad


def _port_op_outputs(core, state, captured):
    """tests/golden/op_suite.compute_op_outputs on the port's modules;
    `captured` receives the riem_solver_c and p_grad_c inputs."""
    return apply_op_suite(halo_updated_inputs(core, state), core.grid_data,
                          core.topo, core.config, core.column_namelist,
                          core.vertical_params, captured)


def halo_updated_inputs(core, state):
    """The operators' inputs: `state`'s fields with the acoustics entry
    halo updates applied, as tests/golden/op_suite.build_inputs does."""
    from pace_torch.parallel import halo as halo_mod

    topo = core.topo
    s = {name: getattr(state, name) for name in state.__dataclass_fields__}
    center = topo.scalar_spec("center")
    for name in ("delp", "pt", "w", "q_con", "omga"):
        s[name] = halo_mod.halo_update_scalar(s[name], center)
    s["u"], s["v"] = halo_mod.halo_update_vector(
        topo, s["u"], s["v"], "y_iface", "x_iface")
    s["uc"], s["vc"] = halo_mod.halo_update_vector(
        topo, s["uc"], s["vc"], "x_iface", "y_iface")
    return s


def apply_op_suite(s, gd, topo, config, col, vp, captured, links=None):
    """tests/golden/op_suite.compute_op_outputs' operators on the fields
    `s` of the block of `topo.domain` (the whole tile, or a rank's part).
    An operator's outputs that feed another are recorded into `links`, or,
    where `links` holds them already, taken from there (so that each
    operator on a block can be fed the whole run's values)."""
    links = {} if links is None else links

    def link(key, value):
        return links.setdefault(key, value)

    from pace_torch.models.fv3.acoustics import _p_grad_c
    from pace_torch.models.fv3.state import NQ, TRACER_NAMES
    from pace_torch.ops import c_sw as c_sw_mod, d_sw as d_sw_mod
    from pace_torch.ops import del2cubed, fxadv, nh_p_grad as nhpg
    from pace_torch.ops import remapping, riemann
    from pace_torch.ops import tracer_advection as tradv
    from pace_torch.ops import updatedz, updatedzd
    from pace_torch.ops.a2b_ord4 import a2b_ord4
    from pace_torch.ops.c2l_ord import cubed_to_latlon
    from pace_torch.ops.fvtp2d import fv_tp_2d
    from pace_torch.ops.xppm import x_flux
    from pace_torch.utils import constants

    dom, nz = topo.domain, NZ
    dt2 = DT / 4
    zeros = torch.zeros_like(s["delp"])
    out = {}

    def rec(name, names, vals):
        out[name] = dict(zip(names, vals))

    csw = c_sw_mod.c_sw(s["delp"], s["pt"], s["u"], s["v"], s["w"],
                        s["omga"], gd, dom, dt2, config.nord)
    rec("c_sw", ["delpc", "ptc", "uc", "vc", "ua", "va", "ut", "vt",
                 "divgd", "omga"], csw[:10])
    csw = link("c_sw", csw)
    fx_adv = fxadv.fx_adv(s["uc"], s["vc"], zeros, zeros, gd, dom, DT / 2)
    rec("fx_adv", ["crx", "cry", "xfx", "yfx", "ut", "vt"], fx_adv)
    crx, cry, xfx, yfx, ut, vt = link("fx_adv", fx_adv)
    rec("fv_tp_2d_damped", ["fx", "fy"],
        fv_tp_2d(s["delp"], crx, cry, xfx, yfx, gd, dom, 6,
                 nord_col=col["nord_v"], damp_c_col=col["damp_vt"]))
    rec("xppm_x_flux", ["flux"],
        [x_flux(s["pt"], crx, gd.horizontal.dxa[..., None], dom, 8)])
    dsw = d_sw_mod.d_sw(
        s["delp"], s["pt"], s["u"], s["v"], s["w"], s["uc"], s["vc"],
        s["ua"], s["va"], csw[8], s["mfxd"], s["mfyd"], s["cxd"],
        s["cyd"], s["q_con"], zeros, s["diss_estd"], ut, vt, gd, col,
        config, dom, DT / 2,
    )
    names = ["delp", "pt", "u", "v", "w", "q_con", "divgd", "delpc", "mfx",
             "mfy", "heat_source"]
    rec("d_sw", names, [dsw[k] for k in names])

    zs = s["phis"] * constants.RGRAV
    gz = link("gz", riemann.column_from_surface(zs, s["delz"]))
    dp_ref = torch.as_tensor(vp["dp_ref"], dtype=gz.dtype)
    gzc, ws3 = updatedz.update_dz_c(dp_ref, zs, gd.horizontal.area, csw[6],
                                    csw[7], gz, dom, dt2)
    rec("update_dz_c", ["gz", "ws3"], [gzc, ws3])
    gzc, ws3 = link("update_dz_c", (gzc, ws3))
    cappa = torch.full_like(s["delp"], 0.28)
    captured["riem_solver_c"] = (
        dt2, cappa, gd.vertical.ptop, s["phis"], ws3, csw[1], s["q_con"],
        csw[0], gzc, s["omga"], config.p_fac)
    gz2, pkc = riemann.riem_solver_c(*captured["riem_solver_c"])
    rec("riem_solver_c", ["gz", "pkc"], [gz2, pkc])
    gz2, pkc = link("riem_solver_c", (gz2, pkc))
    captured["p_grad_c"] = (csw[2], csw[3], csw[0], pkc, gz2)
    rec("p_grad_c", ["uc", "vc"],
        _p_grad_c(*captured["p_grad_c"], gd, dt2))
    zh, wsd = updatedzd.update_dz_d(
        zs, gz[..., :nz + 1], crx, cry, xfx, yfx, gd, col, config, dom,
        DT / 2, vp["dp_ref"])
    rec("update_dz_d", ["zh", "wsd"], [zh, wsd])
    zh, wsd = link("update_dz_d", (zh, wsd))
    r3 = riemann.riem_solver3(
        DT / 2, cappa, gd.vertical.ptop, zs, wsd, s["delz"], s["q_con"],
        s["delp"], s["pt"], zh, s["pe"], torch.zeros_like(s["pe"]), s["pk"],
        s["peln"], s["w"], config.p_fac, config.beta, config.use_logp,
        last_call=True)
    rec("riem_solver3", ["delz", "zh", "pe", "pkc", "pk3", "pk", "peln",
                         "w"], r3)
    r3 = link("riem_solver3", r3)
    un, vn, _, _, _ = nhpg.nh_p_grad(
        s["u"], s["v"], r3[3], r3[1] * constants.GRAV, r3[4], s["delp"], gd,
        dom, DT / 2, gd.vertical.ptop, constants.KAPPA)
    rec("nh_p_grad", ["u", "v"], [un, vn])
    rec("a2b_ord4", ["qb"], [a2b_ord4(s["pt"], gd, dom)])
    rec("del2_cubed", ["q"],
        [del2cubed.hyperdiffusion(s["omga"], gd, 0.2, dom, nmax=2)])
    adv = tradv.tracer_advection(
        {name: s[name] for name in TRACER_NAMES[:NQ]}, s["delp"], s["mfxd"],
        s["mfyd"], s["cxd"], s["cyd"], gd, topo, config.hord_tr)
    rec("tracer_advection", sorted(adv), [adv[k] for k in sorted(adv)])
    rm = remapping.lagrangian_to_eulerian(
        {name: s[name] for name in remapping.REMAP_TRACERS}, s["pt"],
        s["delp"], s["delz"], s["peln"], s["u"], s["v"], s["w"], cappa,
        s["q_con"], s["pkz"], s["pk"], s["pe"], s["phis"], s["ps"],
        torch.zeros_like(s["ps"]), gd, config, dom.n, dom.h, True,
        config.consv_te, DT)
    rec("remapping", ["pt", "delp", "delz", "u", "v", "w", "pkz", "qvapor"],
        [rm["pt"], rm["delp"], rm["delz"], rm["u"], rm["v"], rm["w"],
         rm["pkz"], rm["tracers"]["qvapor"]])
    ua2, va2, _, _ = cubed_to_latlon(s["u"], s["v"], gd, topo, order=4)
    rec("c2l_ord4", ["ua", "va"], [ua2, va2])
    return out


@pytest.fixture(scope="module")
def op_outputs(runs):
    (_, core, states), _ = runs
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    captured = {}
    try:
        outs = _port_op_outputs(core, states[0], captured)
    finally:
        torch.set_num_threads(old)
    return outs, captured


# the one field whose op_suite inputs include undefined halo cells (see the
# module docstring)
OP_TOL = {("p_grad_c", "uc"): 2e-9}


def test_op_digests_match_reference(op_outputs):
    outs, _ = op_outputs
    golden = _load("c12_op_digest.json")
    assert set(outs) == set(golden)
    failures = []
    for op, fields in outs.items():
        for name, arr in fields.items():
            tol = OP_TOL.get((op, name), 1e-9)
            got = op_digest(arr.numpy())
            ref = golden[op][name]
            scale = max(abs(ref["max"]), abs(ref["min"]), 1e-30)
            for stat in ("mean", "std", "min", "max"):
                if abs(got[stat] - ref[stat]) > tol * scale:
                    failures.append(f"{op}.{name}.{stat}: "
                                    f"{got[stat]} != {ref[stat]}")
            if not np.allclose(got["samples"], ref["samples"], rtol=tol,
                               atol=tol * scale, equal_nan=True):
                failures.append(f"{op}.{name}.samples")
    assert not failures, "\n".join(failures[:30])


def test_p_grad_c_matches_reference_on_same_inputs(op_outputs):
    """The reference's riem_solver_c and _p_grad_c on the port's own
    op-suite inputs give the port's outputs to 1e-12 of field scale on the
    compute domain."""
    import jax.numpy as jnp

    from pace_tpu.grid.generation import generate_grid_data as ref_grid
    from pace_tpu.models.fv3.acoustics import _p_grad_c as ref_p_grad_c
    from pace_tpu.ops import riemann as ref_riemann

    outs, captured = op_outputs
    domain = (slice(None), slice(H, H + N_), slice(H, H + N_))

    def check(got, ref):
        got, ref = got.numpy()[domain], np.asarray(ref)[domain]
        # the synthetic op-suite inputs leave NaN in some cells; they must
        # coincide
        scale = float(np.nanmax(np.abs(ref)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale,
                                   equal_nan=True)

    j = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
         for a in captured["riem_solver_c"]]
    for name, ref in zip(("gz", "pkc"), ref_riemann.riem_solver_c(*j)):
        check(outs["riem_solver_c"][name], ref)
    uc, vc, delpc, pkc, gz = (jnp.asarray(a.numpy())
                              for a in captured["p_grad_c"])
    ref = ref_p_grad_c(uc, vc, delpc, pkc, gz,
                       ref_grid(N_, NZ, dtype=jnp.float64),
                       DT / 4, hydrostatic=False)
    for name, r in zip(("uc", "vc"), ref):
        check(outs["p_grad_c"][name], r)
