"""The port's dry convective adjustment (fv_subgridz) against the reference
package's on the same numpy inputs (float64, CPU): every output field and
the two wind tendencies, on convectively unstable and on stable columns,
with and without the relaxation blend, for the sponge depths that select
each temperature bound; `_m_loop` on its own (1e-12 of scale: its inputs
are the same numbers in both); and the conservation laws the reference's
tests hold the scheme to.

The whole scheme is held to 1e-11 of each field's scale, not 1e-12.  Its
sponge geopotential is a cumulative sum of delz, which the two libraries
add up in different orders: on these inputs 13 of 144 sums differ in the
last place (2.1e-16 relative).  The Richardson number then divides by a
difference of neighbouring potential temperatures (about 400 K, a few K
apart) and the mixing mass scales with (1 - ri / ri_ref) ** 2, over three
sweeps; the largest error measured is 1.18e-12 (cloud water, stable
columns, no blend)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import fv_subgridz as ref_sg
from pace_torch.ops import fv_subgridz as sg
from pace_torch.testing import (
    SUBGRIDZ_TRACERS,
    subgridz_inputs,
    torch_threads,
)

DT = 225.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _both(unstable, **kw):
    s = subgridz_inputs(unstable)
    ref, ref_u, ref_v = ref_sg.dry_convective_adjustment(
        {k: jnp.asarray(v) for k, v in s.items()}, DT, **kw)
    got, got_u, got_v = sg.dry_convective_adjustment(
        {k: torch.tensor(v) for k, v in s.items()}, DT, **kw)
    ref = dict({k: np.asarray(v) for k, v in ref.items()},
               u_dt=np.asarray(ref_u), v_dt=np.asarray(ref_v))
    got = dict({k: v.numpy() for k, v in got.items()},
               u_dt=got_u.numpy(), v_dt=got_v.numpy())
    return s, ref, got


def _assert_close(got, ref, tol):
    assert set(got) == set(ref)
    bad = {}
    for key, r in ref.items():
        scale = float(np.abs(r).max())
        if key in ("u_dt", "v_dt"):
            # (u_new - u_old) / dt: the scale of what is subtracted
            scale = float(np.abs(ref["ua" if key == "u_dt" else "va"]).max()
                          ) / DT
        err = float(np.abs(got[key] - r).max())
        if not err <= tol * max(scale, 1e-300):
            bad[key] = (err, scale)
    assert not bad, bad


@pytest.mark.parametrize("unstable", [True, False], ids=["unstable", "stable"])
@pytest.mark.parametrize("kw", [
    dict(fv_sg_adj=3600.0, n_sponge=24),
    dict(fv_sg_adj=225.0, n_sponge=24),
    dict(fv_sg_adj=3600.0, n_sponge=10, ptop=1.0),
    dict(fv_sg_adj=900.0, n_sponge=30, nwat=0),
], ids=["blend_k24", "no_blend_k24", "k10_ptop1", "whole_column_nwat0"])
def test_dry_convective_adjustment_matches_reference(unstable, kw):
    s, ref, got = _both(unstable, **kw)
    _assert_close(got, ref, 1e-11)
    kbot = kw["n_sponge"]
    dpt = got["pt"] - s["pt"]
    if unstable:
        assert np.abs(dpt[..., :kbot]).max() > 0.01
        assert np.abs(got["u_dt"]).max() > 0
        assert np.abs(got["qvapor"] - s["qvapor"]).max() > 0
    if kbot < dpt.shape[-1]:
        assert np.abs(dpt[..., kbot:]).max() == 0.0
        assert np.abs(got["u_dt"][..., kbot:]).max() == 0.0


def test_m_loop_matches_reference():
    s = subgridz_inputs(True)
    kbot = 12
    rng = np.random.default_rng(0)
    shape = s["pt"].shape[:-1] + (kbot,)
    names = list(SUBGRIDZ_TRACERS) + ["u0", "v0", "w0", "t0", "se", "te",
                                      "cpm", "cvm", "gz"]
    f = {n: s[n][..., :kbot] for n in SUBGRIDZ_TRACERS}
    f.update(u0=s["ua"][..., :kbot], v0=s["va"][..., :kbot],
             w0=s["w"][..., :kbot], t0=s["pt"][..., :kbot],
             gz=np.cumsum(rng.uniform(2e3, 4e3, shape)[..., ::-1],
                          -1)[..., ::-1].copy())
    f["cpm"] = np.full(shape, 1004.6)
    f["cvm"] = np.full(shape, 717.55)
    tv = f["gz"] + 0.5 * (f["u0"] ** 2 + f["v0"] ** 2 + f["w0"] ** 2)
    f["se"] = f["cpm"] * f["t0"] + tv
    f["te"] = f["cvm"] * f["t0"] + tv
    delp, pkz = s["delp"][..., :kbot], s["pkz"][..., :kbot]
    dlogp = np.diff(s["peln"][..., :kbot + 1], axis=-1)
    mult = np.array([1.0, 4.0, 2.0, 1.5] + [1.0] * (kbot - 4))
    args = (mult, kbot, 0.5, 0.608, 325.0, 165.0, names)
    ref = ref_sg._m_loop({k: jnp.asarray(v) for k, v in f.items()},
                         jnp.asarray(delp), jnp.asarray(pkz),
                         jnp.asarray(dlogp), *args)
    got = sg._m_loop({k: torch.tensor(v) for k, v in f.items()},
                     torch.tensor(delp), torch.tensor(pkz),
                     torch.tensor(dlogp), *args)
    assert np.abs(np.asarray(ref["t0"]) - f["t0"]).max() > 0.01
    _assert_close({k: v.numpy() for k, v in got.items()},
                  {k: np.asarray(v) for k, v in ref.items()}, 1e-12)


def test_small_sponge_is_a_noop():
    s = {k: torch.tensor(v) for k, v in subgridz_inputs(True).items()}
    out, u_dt, v_dt = sg.dry_convective_adjustment(s, DT, 3600.0, 2)
    assert out is s
    assert float(u_dt.abs().max()) == 0.0 and float(v_dt.abs().max()) == 0.0


def test_hydrostatic_raises():
    s = {k: torch.tensor(v) for k, v in subgridz_inputs(True).items()}
    with pytest.raises(NotImplementedError):
        sg.dry_convective_adjustment(s, DT, 3600.0, 24, hydrostatic=True)


def test_tracer_and_momentum_conservation():
    """The 2-layer mixing moves mass-weighted quantities between adjacent
    levels only: column integrals of dp*q and dp*u are conserved."""
    s, _, got = _both(True, fv_sg_adj=225.0, n_sponge=24)
    for name in ("qvapor", "qo3mr", "ua", "va"):
        before = (s["delp"] * s[name]).sum(-1)
        after = (s["delp"] * got[name]).sum(-1)
        np.testing.assert_allclose(after, before, rtol=1e-12, atol=1e-10)
