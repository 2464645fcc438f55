"""The dycore branches of ROADMAP Queue 1 item 8, each against the live
reference function on the same float64 inputs at 1e-12 of field scale:
remap_profile and map_single at kord 8 and 10 with every remap mode iv,
d_sw with do_skeb, and tracer advection with the dynamic subcycle at three
trip counts.

The inputs are built as tests/golden/op_suite.py:build_inputs builds them
(the C12/79 float64 state after one step, the acoustics' entry halo
updates applied), from the port's own step so that no whole JAX step is
compiled here; both packages then get the same numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads
from pace_torch.utils.gridtools import Domain

N_, NZ, H, DT = 12, 79, 3, 225.0
C = (slice(None), slice(H, H + N_), slice(H, H + N_))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def inputs():
    """(port grid data, reference grid data, {name: numpy array}) of
    op_suite's inputs."""
    from pace_torch.parallel import halo as halo_mod
    from pace_torch.testing import c12_dycore_run
    from pace_tpu.grid.generation import generate_grid_data as ref_grid

    _, core, (_, state) = c12_dycore_run(torch.float64, 1)
    gd = core.grid_data
    s = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    topo = core.topo
    center = topo.scalar_spec("center")
    for name in ("delp", "pt", "w", "q_con", "omga"):
        s[name] = halo_mod.halo_update_scalar(s[name], center)
    s["u"], s["v"] = halo_mod.halo_update_vector(
        topo, s["u"], s["v"], "y_iface", "x_iface")
    s["uc"], s["vc"] = halo_mod.halo_update_vector(
        topo, s["uc"], s["vc"], "x_iface", "y_iface")
    arrays = {k: v.numpy() for k, v in s.items()}
    return gd, ref_grid(N_, NZ, dtype=jnp.float64), arrays


def _close(got, ref, tol=1e-12, region=C, scale=None):
    """|got - ref| <= tol * scale on `region`, non-finite values at the
    same places; scale is max |ref| there unless given."""
    got = np.asarray(got)[region]
    ref = np.asarray(ref)[region]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    if scale is None:
        scale = float(np.nanmax(np.abs(ref))) + 1e-300
    err = float(np.nanmax(np.abs(got - ref)))
    assert err <= tol * scale, (err, scale)


# one field per remap mode, as the remap gives it that mode: w (-2, with
# its surface value), u (-1), the tracers (0), delz (1); iv = 2 on pt (the
# start's only non-zero tracer is qvapor)
FIELD_OF_MODE = {-2: "w", -1: "u", 0: "qvapor", 1: "delz", 2: "pt"}


@pytest.mark.parametrize("iv", sorted(FIELD_OF_MODE))
@pytest.mark.parametrize("kord", [8, 10])
def test_remap_profile_and_map_single_match_reference(inputs, kord, iv,
                                                      monkeypatch):
    """The spline's interface values agree to 1e-12 of the field's scale,
    not bit for bit (the two packages' tridiagonal solves round
    differently).  kord 10 branches on |2 a1 - (a2 + a3)| > |a2 - a3|,
    which is an exact tie wherever the monotonicity clamp set an interface
    to its cell's mean, so a one-ulp difference there picks the other
    branch.  The port's constraints therefore run on the reference's own
    interface values, and every branch is held to the reference's."""
    from pace_torch.ops import remap_profile as port_profile
    from pace_torch.ops.map_single import map_single
    from pace_tpu.ops import remap_profile as ref_profile_mod
    from pace_tpu.ops.map_single import map_single as ref_map_single

    remap_profile = port_profile.remap_profile
    ref_profile = ref_profile_mod.remap_profile
    spline = port_profile._spline_interfaces

    def reference_spline(a1, delp, qs, iv):
        q_if, _ = ref_profile_mod._spline_interfaces(
            jnp.asarray(a1.numpy()), jnp.asarray(delp.numpy()),
            jnp.asarray(qs.numpy()), iv)
        mine = spline(a1, delp, qs, iv)
        _close(mine.numpy(), q_if, region=...,
               scale=float(a1.abs().max()))
        return torch.as_tensor(np.array(q_if))

    monkeypatch.setattr(port_profile, "_spline_interfaces", reference_spline)

    gd, _, s = inputs
    q = s[FIELD_OF_MODE[iv]][C]
    pe1 = s["pe"][C]
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    qs = s["w"][C][..., -1] if iv == -2 else np.zeros(q.shape[:-1])
    ak = gd.vertical.ak.numpy()
    bk = gd.vertical.bk.numpy()
    pe2 = np.concatenate(
        [pe1[..., :1], ak[1:NZ] + bk[1:NZ] * pe1[..., -1:], pe1[..., -1:]],
        -1)
    t = [torch.as_tensor(a) for a in (qs, q, dp1, pe1, pe2)]

    # the scale of the remapped field: the profile's curvature coefficient
    # a4_4 is a difference of values of that size
    scale = float(np.abs(q).max())
    got = remap_profile(t[0], t[1], t[2], N_, H, kord, iv)
    ref = ref_profile(qs, q, dp1, N_, H, kord, iv)
    for g, r in zip(got, ref):
        _close(g.numpy(), r, region=..., scale=scale)

    got = map_single(t[1], t[3], t[4], N_, H, kord, iv, qs=t[0])
    ref = ref_map_single(q, pe1, pe2, N_, H, kord, iv, qs=qs)
    _close(got.numpy(), ref, region=..., scale=scale)


def test_d_sw_with_skeb_matches_reference(inputs):
    from pace_torch.models.fv3.config import (
        DynamicalCoreConfig,
        get_column_namelist,
    )
    from pace_torch.ops import c_sw, d_sw, fxadv
    from pace_tpu.models.fv3.config import DynamicalCoreConfig as RefConfig
    from pace_tpu.ops import d_sw as ref_d_sw

    gd, ref_gd, s = inputs
    config = DynamicalCoreConfig(do_sat_adj=False, do_skeb=True)
    ref_config = RefConfig(do_sat_adj=False, do_skeb=True)
    col = get_column_namelist(config, NZ)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    csw = c_sw.c_sw(t["delp"], t["pt"], t["u"], t["v"], t["w"], t["omga"],
                    gd, Domain.whole(N_, H), DT / 4, config.nord)
    zeros = torch.zeros_like(t["delp"])
    *_, ut, vt = fxadv.fx_adv(t["uc"], t["vc"], zeros, zeros, gd,
                              Domain.whole(N_, H), DT / 2)
    names = ("delp", "pt", "u", "v", "w", "uc", "vc", "ua", "va")
    args = ([t[k] for k in names] + [csw[8]]
            + [t[k] for k in ("mfxd", "mfyd", "cxd", "cyd", "q_con")]
            + [zeros, t["diss_estd"], ut, vt])
    got = d_sw.d_sw(*args, gd, col, config, Domain.whole(N_, H), DT / 2)
    ref = jax.jit(lambda *a: ref_d_sw.d_sw(
        *a, ref_gd, col, ref_config, N_, H, DT / 2))(
        *[a.numpy() for a in args])
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name].numpy(), ref[name])
    # skeb's dissipation estimate is the damping term: non-zero inside
    assert float(np.nanmax(np.abs(got["diss_est"].numpy()[C]))) > 0.0


@pytest.mark.parametrize("trips", [1, 3, 4])
def test_dynamic_subcycle_matches_reference(inputs, trips):
    """Courant numbers and mass fluxes scaled so that the largest |Courant
    number| on the compute domain is trips - 0.5: the trip count
    floor(1 + max |C|) is `trips`, and the reference's own while loop must
    have taken as many substeps for the results to agree."""
    from pace_torch.ops import tracer_advection as tradv
    from pace_torch.parallel.topology import get_topology
    from pace_tpu.ops import tracer_advection as ref_tradv
    from pace_tpu.parallel.topology import get_topology as ref_topology

    gd, ref_gd, s = inputs
    cx, cy = s["cxd"], s["cyd"]
    cmax = max(np.abs(cx[:, H:H + N_ + 1, H:H + N_]).max(),
               np.abs(cy[:, H:H + N_, H:H + N_ + 1]).max())
    scale = (trips - 0.5) / cmax
    fluxes = [s[k] * scale for k in ("mfxd", "mfyd", "cxd", "cyd")]
    tracers = {k: s[k] for k in ("qvapor", "pt")}

    t = [torch.as_tensor(a) for a in fluxes]
    assert tradv.subcycle_count(t[2], t[3], Domain.whole(N_, H)) == trips
    got = tradv.tracer_advection(
        {k: torch.as_tensor(v) for k, v in tracers.items()},
        torch.as_tensor(s["delp"]), *t, gd, get_topology(N_, H), 8,
        dynamic_subcycle=True)
    ref = jax.jit(lambda q, dp, *f: ref_tradv.tracer_advection(
        q, dp, *f, ref_gd, ref_topology(N_, H), N_, H, 8,
        dynamic_subcycle=True))(tracers, s["delp"], *fluxes)
    for name in tracers:
        _close(got[name].numpy(), ref[name])
