"""The port's dycore-physics coupler against the reference package's on the
same numpy inputs (float64, CPU, the C12/79 grid): the A-grid to D-grid
wind update, the moist temperature update, the pressure rebuild, the two
borrowing sweeps of `fill_gfs_delp`, the tracer conversion,
`DycoreToPhysics` and both branches of `UpdateAtmosphereState`, within
1e-12 of each field's scale on the compute domain."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import generate_grid_data as ref_grid
from pace_tpu.models.coupler import fv_update_phys as ref_fvup
from pace_tpu.models.coupler import update_atmos_state as ref_uas
from pace_tpu.models.coupler import update_dwind_phys as ref_udp
from pace_tpu.models.fv3.init.baroclinic import (
    init_baroclinic_state as ref_init,
)
from pace_tpu.models.physics.physics_state import (
    PhysicsState as RefPhysicsState,
)
from pace_tpu.parallel.topology import get_topology as ref_topology
from pace_tpu.utils.gridtools import GridSizing as RefSizing
from pace_torch.grid.generation import generate_grid_data
from pace_torch.models.coupler import fv_update_phys as fvup
from pace_torch.models.coupler import update_atmos_state as uas
from pace_torch.models.coupler import update_dwind_phys as udp
from pace_torch.models.fv3.state import DycoreState
from pace_torch.models.physics.physics_state import PhysicsState
from pace_torch.parallel.topology import get_topology
from pace_torch.testing import torch_threads
from pace_torch.utils.gridtools import Domain, GridSizing

N_, NZ, H, DT = 12, 79, 3, 225.0
DOM = (slice(None), slice(H, H + N_), slice(H, H + N_))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def grids():
    return (ref_grid(N_, NZ, dtype=jnp.float64), ref_topology(N_, H),
            generate_grid_data(N_, NZ, device="cpu", dtype=torch.float64),
            get_topology(N_, H))


@pytest.fixture(scope="module")
def dycore_arrays():
    """The baroclinic C12/79 state as numpy, with condensates and vertical
    motion added so that every term of the coupler is exercised."""
    state = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    arrays = {f.name: np.array(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    rng = np.random.default_rng(8)
    shape = arrays["pt"].shape
    for name, top in (("qliquid", 1e-3), ("qrain", 5e-4), ("qice", 1e-4),
                      ("qsnow", 1e-4), ("qgraupel", 1e-4)):
        arrays[name] = top * rng.uniform(0.0, 1.0, shape)
    arrays["w"] = 0.1 * rng.standard_normal(shape)
    arrays["omga"] = rng.standard_normal(shape)
    return arrays


def _close(got, ref, tol=1e-12, where=DOM, label=""):
    g = got.numpy()[where] if where else got.numpy()
    r = np.asarray(ref)[where] if where else np.asarray(ref)
    assert g.shape == r.shape, label
    err = float(np.abs(g - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1e-300), (label, err)


def test_edge_neighbor_index_and_mask_equal_reference():
    N = 24
    dom = Domain.whole(N_, H)
    for axis in (1, 2):
        np.testing.assert_array_equal(udp._edge_neighbor_index(dom, axis),
                                      ref_udp._edge_neighbor_index(N_, H, N))
    np.testing.assert_array_equal(
        uas.interior_mask(dom, device="cpu").numpy(),
        np.asarray(ref_uas.interior_mask(N, N_, H)))


def test_update_dwind_phys_matches_reference(grids, dycore_arrays):
    ref_gd, ref_topo, gd, topo = grids
    rng = np.random.default_rng(1)
    shape = dycore_arrays["u"].shape[:3] + (5,)
    u, v = dycore_arrays["u"][..., :5], dycore_arrays["v"][..., :5]
    u_dt = 1e-3 * rng.standard_normal(shape)
    v_dt = 1e-3 * rng.standard_normal(shape)
    ref = ref_udp.update_dwind_phys(
        *(jnp.asarray(a) for a in (u, v, u_dt, v_dt)), ref_gd, ref_topo, N_,
        H, DT)
    got = udp.update_dwind_phys(
        *(torch.tensor(a) for a in (u, v, u_dt, v_dt)), gd, topo, DT)
    for g, r, stag, name in zip(got, ref, ((0, 1), (1, 0)), "uv"):
        where = (slice(None), slice(H, H + N_ + stag[0]),
                 slice(H, H + N_ + stag[1]))
        _close(g, r, where=where, label=name)
        before = (u if name == "u" else v)[where]
        assert np.abs(np.asarray(r)[where] - before).max() > 1e-3


def test_moist_cv_and_pressure_update_match_reference(dycore_arrays):
    a = dycore_arrays
    rng = np.random.default_rng(2)
    t_dt = 1e-3 * rng.standard_normal(a["pt"].shape)
    names = ("qvapor", "qliquid", "qrain", "qsnow", "qice", "qgraupel", "pt")
    ref = ref_fvup.moist_cv_apply_t_dt(
        *(jnp.asarray(a[k]) for k in names), jnp.asarray(t_dt), DT)
    got = fvup.moist_cv_apply_t_dt(
        *(torch.tensor(a[k]) for k in names), torch.tensor(t_dt), DT)
    _close(got, ref, label="pt")
    names = ("pe", "delp", "peln", "pk", "ua", "va")
    ref = ref_fvup.update_pressure_and_surface_winds(
        *(jnp.asarray(a[k]) for k in names))
    got = fvup.update_pressure_and_surface_winds(
        *(torch.tensor(a[k]) for k in names))
    for g, r, name in zip(got, ref, ("pe", "peln", "pk", "ps", "u_srf",
                                     "v_srf")):
        _close(g, r, label=name)
        # padded columns carry pe = 0: the clamp keeps them finite
        assert bool(torch.isfinite(g).all()), name


@pytest.mark.parametrize("q_min", [1.0e-9, 0.0])
def test_fill_gfs_delp_matches_reference(q_min):
    rng = np.random.default_rng(3)
    shape = (3, 4, 5, 20)
    delp = rng.uniform(300.0, 1800.0, shape)
    q = rng.uniform(0.0, 1e-3, shape)
    q[rng.uniform(size=shape) < 0.25] = -1e-4
    q[0, 0, 0] = -1e-4          # a column that cannot be made whole
    q[0, 0, 1, -1] = -1e-3      # a negative at the ground
    q[0, 0, 2, 0] = -1e-3       # and at the top
    ref = ref_uas.fill_gfs_delp(jnp.asarray(delp), jnp.asarray(q), q_min)
    got = uas.fill_gfs_delp(torch.tensor(delp), torch.tensor(q), q_min)
    _close(got, ref, where=None)
    assert float(got.min()) >= 0.0
    assert np.abs(got.numpy() - q).max() > 1e-5


def _physics_arrays(dycore_arrays):
    """A PhysicsState as numpy: what DycoreToPhysics copies, then seeded
    `physics_updated_*` fields and interface pressures as Physics would
    leave them."""
    rng = np.random.default_rng(4)
    a = dycore_arrays
    shape = a["pt"].shape
    ref0 = RefPhysicsState.init_zeros(shape, dtype=jnp.float64)
    out = {f.name: np.array(getattr(ref0, f.name))
           for f in dataclasses.fields(ref0)}
    for name in ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel",
                 "pt", "delp", "ua", "va"):
        out[name] = a[name]
    out["prsi"] = np.concatenate(
        [np.full(shape[:3] + (1,), 300.0),
         300.0 + np.cumsum(np.maximum(a["delp"], 1.0) * 0.999, -1)], -1)
    for field, src, amp in (
            ("specific_humidity", "qvapor", 1e-4),
            ("qliquid", "qliquid", 1e-5),
            ("qrain", "qrain", 1e-5), ("qice", "qice", 1e-6),
            ("qsnow", "qsnow", 1e-6), ("qgraupel", "qgraupel", 1e-6),
            ("pt", "pt", 0.5), ("ua", "ua", 0.1), ("va", "va", 0.1)):
        out["physics_updated_" + field] = (
            a[src] + amp * rng.standard_normal(shape))
    return out


def test_prepare_tendencies_matches_reference(dycore_arrays):
    phy = _physics_arrays(dycore_arrays)
    zeros = np.zeros(dycore_arrays["pt"].shape)
    ref = ref_uas.prepare_tendencies_and_update_tracers(
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(zeros),
        RefPhysicsState(**{k: jnp.asarray(v) for k, v in phy.items()}),
        {k: jnp.asarray(v) for k, v in dycore_arrays.items()}, 1.0 / DT)
    got = uas.prepare_tendencies_and_update_tracers(
        torch.tensor(zeros), torch.tensor(zeros), torch.tensor(zeros),
        PhysicsState.from_numpy(phy, "cpu", torch.float64),
        {k: torch.tensor(v) for k, v in dycore_arrays.items()}, 1.0 / DT)
    for g, r, name in zip(got[:3], ref[:3], ("u_dt", "v_dt", "pt_dt")):
        _close(g, r, label=name)
    assert sorted(got[3]) == sorted(ref[3])
    for name in ref[3]:
        _close(got[3][name], ref[3][name], label=name)
    _close(got[4], ref[4], label="delp")


def test_dycore_to_physics_matches_reference(dycore_arrays):
    sizing = RefSizing(N_, NZ)
    ref_state = ref_init(sizing, dtype=jnp.float64)
    ref_state = dataclasses.replace(
        ref_state, **{k: jnp.asarray(v) for k, v in dycore_arrays.items()})
    ref = ref_uas.DycoreToPhysics(sizing, dtype=jnp.float64)(ref_state)
    got = uas.DycoreToPhysics(GridSizing(N_, NZ), dtype=torch.float64,
                              device="cpu")(
        DycoreState.from_numpy(dycore_arrays, "cpu", torch.float64))
    for f in dataclasses.fields(ref):
        # whole arrays: the padded columns hold the benign fill values
        np.testing.assert_array_equal(
            getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name)),
            err_msg=f.name)
    assert float(got.pt[0, 0, 0, 0]) == 273.0
    assert float(got.delz[0, 0, 0, 0]) == -100.0


@pytest.mark.parametrize("dycore_only", [False, True],
                         ids=["coupled", "dycore_only"])
def test_update_atmosphere_state_matches_reference(grids, dycore_arrays,
                                                   dycore_only):
    ref_gd, ref_topo, gd, topo = grids
    phy = _physics_arrays(dycore_arrays)
    rng = np.random.default_rng(5)
    shape = dycore_arrays["pt"].shape
    u_dt0 = 1e-4 * rng.standard_normal(shape)
    v_dt0 = 1e-4 * rng.standard_normal(shape)
    arrays = dict(dycore_arrays)
    arrays["qvapor"] = arrays["qvapor"] - 2e-3  # negatives to fill

    ref_state = ref_init(RefSizing(N_, NZ), dtype=jnp.float64)
    ref_state = dataclasses.replace(
        ref_state, **{k: jnp.asarray(v) for k, v in arrays.items()})
    ref = ref_uas.UpdateAtmosphereState(
        ref_gd, ref_topo, RefSizing(N_, NZ), DT, dycore_only=dycore_only)(
        ref_state,
        RefPhysicsState(**{k: jnp.asarray(v) for k, v in phy.items()}),
        u_dt0=jnp.asarray(u_dt0), v_dt0=jnp.asarray(v_dt0))
    got = uas.UpdateAtmosphereState(
        gd, topo, GridSizing(N_, NZ), DT, dycore_only=dycore_only,
        device="cpu")(
        DycoreState.from_numpy(arrays, "cpu", torch.float64),
        PhysicsState.from_numpy(phy, "cpu", torch.float64),
        u_dt0=torch.tensor(u_dt0), v_dt0=torch.tensor(v_dt0))
    changed = []
    for f in dataclasses.fields(ref):
        _close(getattr(got, f.name), getattr(ref, f.name), label=f.name)
        if np.abs(np.asarray(getattr(ref, f.name))[DOM]
                  - arrays[f.name][DOM]).max() > 0:
            changed.append(f.name)
    if dycore_only:
        assert changed == ["qvapor"]
    else:
        assert {"u", "v", "ua", "va", "pt", "delp", "pe", "peln", "pk", "ps",
                "qvapor", "qliquid", "qrain", "qice", "qsnow",
                "qgraupel"} <= set(changed)


def test_coupler_on_the_wrong_device_raises(grids):
    _, _, gd, topo = grids
    with pytest.raises(ValueError):
        uas.UpdateAtmosphereState(gd, topo, GridSizing(N_, NZ), DT,
                                  device="meta")
