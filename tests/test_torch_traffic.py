"""Halo-traffic record/replay in the port (parallel/traffic.py): the four
cases of tests/test_traffic_replay.py with the port's recorder, and the
replayed tile against the reference recorder's replay of the same
`_mini_model` on the same numpy inputs (1e-12: the small stencil's sums
may round differently in the two libraries).  Also tracer advection's
tracer-stack halo calls recorded and one tile replayed alone, and (slow)
a whole dycore step."""

import numpy as np
import pytest
import torch

from pace_torch.parallel import halo as halo_mod
from pace_torch.parallel.partition import Partition
from pace_torch.parallel.topology import get_topology
from pace_torch.parallel.traffic import HaloTrafficRecorder
from pace_torch.testing import torch_threads

N_, H = 12, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def topo():
    return get_topology(N_, H)


def _mini_model(topo, q, u, v):
    """Scalar and vector updates with local stencil work in between (the
    reference test's `_mini_model`, in torch)."""
    spec = topo.scalar_spec("center")
    q = halo_mod.halo_update_scalar(q, spec)
    q = q + 0.25 * (
        torch.roll(q, 1, dims=1) + torch.roll(q, -1, dims=1)
        + torch.roll(q, 1, dims=2) + torch.roll(q, -1, dims=2)
    )
    u, v = halo_mod.halo_update_vector(topo, u, v, "y_iface", "x_iface")
    div = u + v + q
    u, v = halo_mod.synchronize_vector_interfaces(
        topo, u, v, "y_iface", "x_iface")
    return q, u, v, div


def _fields(seed, topo, count=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(6, topo.N, topo.N) for _ in range(count)]


def test_record_then_replay_single_tile(topo, tmp_path):
    q, u, v = (torch.tensor(a) for a in _fields(11, topo))
    rec = HaloTrafficRecorder.recording()
    with rec:
        full = _mini_model(topo, q, u, v)
    assert len(rec.calls) == 5  # 1 scalar + 2 vector comps + 2 sync comps

    path = str(tmp_path / "traffic.npz")
    rec.save(path)
    loaded = HaloTrafficRecorder.load(path)
    assert len(loaded.calls) == len(rec.calls)

    tile = 4
    with loaded.replaying(tile=tile):
        solo = _mini_model(topo, q[tile:tile + 1], u[tile:tile + 1],
                           v[tile:tile + 1])
    for got, want in zip(solo, full):
        assert torch.equal(got[0], want[tile])


def test_replayed_tile_matches_the_reference_replay(topo, tmp_path):
    """The same inputs through the reference package's recorder and
    mini model (in its gather lowering, whose recording holds whole
    results as the port's does): the replayed tile agrees within 1e-12."""
    import jax.numpy as jnp

    from pace_tpu.parallel import copyops
    from pace_tpu.parallel import halo as ref_halo
    from pace_tpu.parallel.topology import get_topology as ref_topology
    from pace_tpu.parallel.traffic import HaloTrafficRecorder as RefRec

    arrays = _fields(11, topo)
    ref_topo = ref_topology(N_, H)

    def ref_model(q, u, v):
        spec = ref_topo.scalar_spec("center")
        q = ref_halo.halo_update_scalar(q, spec)
        q = q + 0.25 * (
            jnp.roll(q, 1, axis=1) + jnp.roll(q, -1, axis=1)
            + jnp.roll(q, 1, axis=2) + jnp.roll(q, -1, axis=2))
        u, v = ref_halo.halo_update_vector(ref_topo, u, v, "y_iface",
                                           "x_iface")
        div = u + v + q
        u, v = ref_halo.synchronize_vector_interfaces(
            ref_topo, u, v, "y_iface", "x_iface")
        return q, u, v, div

    tile = 2
    ref_rec = RefRec.recording()
    mode, copyops.HALO_MODE = copyops.HALO_MODE, "gather"
    try:
        with ref_rec:
            ref_model(*(jnp.asarray(a) for a in arrays))
        with ref_rec.replaying(tile=tile):
            want = ref_model(*(jnp.asarray(a[tile:tile + 1])
                               for a in arrays))
    finally:
        copyops.HALO_MODE = mode

    rec = HaloTrafficRecorder.recording()
    with rec:
        _mini_model(topo, *(torch.tensor(a) for a in arrays))
    rec.save(str(tmp_path / "t.npz"))
    with HaloTrafficRecorder.load(str(tmp_path / "t.npz")).replaying(
            tile=tile):
        got = _mini_model(topo, *(torch.tensor(a[tile:tile + 1])
                                  for a in arrays))
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= 1e-12 * scale


def test_replay_full_cube(topo):
    """tile=None replays onto whole-cube arrays: the recorded values
    where a point's source lies on another tile, the arrays' own gather
    elsewhere (zeros here, where zeros are replayed onto)."""
    q = torch.tensor(_fields(12, topo, 1)[0])
    spec = topo.scalar_spec("center")
    rec = HaloTrafficRecorder.recording()
    with rec:
        full = halo_mod.halo_update_scalar(q, spec)
    with rec.replaying():
        replayed = halo_mod.halo_update_scalar(q, spec)
    assert torch.equal(replayed, full)
    with rec.replaying():
        received = halo_mod.halo_update_scalar(torch.zeros_like(q), spec)
    other = torch.as_tensor(spec.src_tile != np.arange(6)[:, None, None])
    assert other.any() and not other.all()
    assert torch.equal(received, torch.where(other, full, 0.0))


def test_replay_reads_only_the_neighbours_values(topo):
    """The replayed tile computes on its own values: with the recording
    poisoned where no halo call reads another tile (the compute domain
    less its edge rows), the tile still steps to the whole run's values."""
    q, u, v = (torch.tensor(a) for a in _fields(14, topo))
    rec = HaloTrafficRecorder.recording()
    with rec:
        full = _mini_model(topo, q, u, v)
    inner = slice(H + 1, H + N_ - 1)
    for _, _, payload in rec.calls:
        payload[:, inner, inner] = np.nan
    tile = 1
    with rec.replaying(tile=tile):
        solo = _mini_model(topo, q[tile:tile + 1], u[tile:tile + 1],
                           v[tile:tile + 1])
    for got, want in zip(solo, full):
        assert torch.equal(got[0], want[tile])


def test_replay_mismatch_raises(topo):
    q, u, v = (torch.tensor(a) for a in _fields(13, topo))
    spec = topo.scalar_spec("center")
    rec = HaloTrafficRecorder.recording()
    with rec:
        halo_mod.halo_update_scalar(q, spec)
    rep = rec.replaying(tile=0)
    with rep:
        # vector update where a scalar was recorded -> kind mismatch
        with pytest.raises(RuntimeError, match="mismatch"):
            halo_mod.halo_update_vector(topo, u[:1], v[:1], "y_iface",
                                        "x_iface")
        rep.cursor = 0
        halo_mod.halo_update_scalar(q[:1], spec)
        with pytest.raises(RuntimeError, match="exhausted"):
            halo_mod.halo_update_scalar(q[:1], spec)
    with pytest.raises(ValueError, match="replaying"):
        with HaloTrafficRecorder():
            pass


def test_record_tracer_advection_then_replay_one_tile(topo):
    """Tracer advection's corner-composed halo gathers of the tracer stack
    are recorded, and one tile replays them alone, equal to the whole
    run's tile."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.ops import tracer_advection as tradv

    rng = np.random.RandomState(3)
    nz, tile = 4, 5
    arrays = [rng.rand(6, topo.N, topo.N, nz) + 1.0 for _ in range(7)]
    arrays[5:7] = [0.1 * a for a in arrays[5:7]]  # the Courant numbers

    def run(grid, cut):
        fields = [torch.tensor(a[cut]) for a in arrays]
        tracers = {"qvapor": fields[0], "qcld": fields[1]}
        return tradv.tracer_advection(tracers, *fields[2:7], grid, topo,
                                      hord_tr=8)

    rec = HaloTrafficRecorder.recording()
    with rec:
        out = run(generate_grid_data(N_, 79, device="cpu",
                                     dtype=torch.float64), slice(None))
    assert len(rec.calls) == 6  # q_y and q_x of three substeps
    with rec.replaying(tile=tile):
        solo = run(generate_grid_data(N_, 79, device="cpu",
                                      dtype=torch.float64,
                                      scatter=Partition((6, 1, 1), N_)
                                      .scatterer(tile)),
                   slice(tile, tile + 1))
    for name, value in out.items():
        assert np.isfinite(value[:, H:H + N_, H:H + N_].numpy()).all()
        assert torch.equal(solo[name][0], value[tile])


@pytest.mark.slow
def test_record_a_dycore_step_then_replay_one_tile():
    """A C12/79 float64 dycore step recorded on the whole cube, then tile 2
    stepped alone on its own grid and state with the recording: every
    field of the tile equal to the whole run's (NaNs at the same
    places)."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing, tile = GridSizing(N_, 79), 2
    config = DynamicalCoreConfig(do_sat_adj=False)

    def step(scatter=None):
        kw = dict(device="cpu", dtype=torch.float64, scatter=scatter)
        core = DynamicalCore(config, sizing,
                             generate_grid_data(N_, 79, **kw), timestep=225.0)
        return core.step_dynamics(init_baroclinic_state(sizing, **kw))

    rec = HaloTrafficRecorder.recording()
    with rec:
        full = step()
    replay = rec.replaying(tile=tile)
    with replay:
        solo = step(Partition((6, 1, 1), N_).scatterer(tile))
    assert replay.cursor == len(rec.calls) > 20
    for name in full.__dataclass_fields__:
        want = getattr(full, name)[tile]
        got = getattr(solo, name)[0]
        assert torch.equal(torch.nan_to_num(got, 1e300),
                           torch.nan_to_num(want, 1e300)), name
