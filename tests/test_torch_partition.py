"""The halo exchange over ranks (parallel/partition.py, comm.py, halo.py
`RankTopology`) at C12, in one process.

Each rank of a layout runs the port's halo functions in a thread of its
own on its held part of a seeded field, with its exchanges routed through
the other threads; the points it holds but does not own start as NaN, so
a result can only be right if every value came from its owner.  On every
rank's box the result must equal, bit for bit, what the one-rank global
gather gives, and that must equal `pace_tpu.parallel.halo` on the same
numpy input: for the scalar (centre and corner), grouped, corner-composed
(the transport's), vector (D, C and A grid), staggered-pair and
interface-sync calls, on the whole-tile layouts (1, 1, 1), (2, 1, 1),
(3, 1, 1), (6, 1, 1) and the box layouts (2, 2, 2), (1, 2, 4) of
tests/test_sharded_step.py.  Also: the plans' received rows are the halo
surface, the layout validation, and a state scattered and gathered back."""

import threading

import numpy as np
import pytest
import torch

from pace_torch.parallel import halo
from pace_torch.parallel.partition import Partition, check_layout
from pace_torch.parallel.topology import get_topology

N_, H, NZ = 12, 3, 3
LAYOUTS = [(1, 1, 1), (2, 1, 1), (3, 1, 1), (6, 1, 1), (2, 2, 2),
           (1, 2, 4)]


def _call(kind, topo, f):
    """One halo call of `kind` on fields f (port or reference module)."""
    q, w, u, v, stack = f["q"], f["w"], f["u"], f["v"], f["stack"]
    if kind == "scalar":
        return [halo.halo_update_scalar(q, topo.scalar_spec("center"))]
    if kind == "corner":
        return [halo.halo_update_scalar(q, topo.scalar_spec("corner"))]
    if kind == "grouped":
        return halo.halo_update_scalars(topo, [q, w])
    if kind == "corners":
        return list(halo.halo_update_corners(topo, stack))
    if kind == "pair":
        return list(halo.halo_update_staggered_pair(topo, u, v, "y_iface",
                                                    "x_iface"))
    if kind.startswith("sync"):
        return list(halo.synchronize_vector_interfaces(topo, u, v,
                                                       *STAGGER[kind]))
    return list(halo.halo_update_vector(topo, u, v, *STAGGER[kind]))


STAGGER = {"vector_d": ("y_iface", "x_iface"),
           "vector_c": ("x_iface", "y_iface"),
           "vector_a": ("center", "center"),
           "sync_d": ("y_iface", "x_iface"),
           "sync_c": ("x_iface", "y_iface")}
KINDS = ["scalar", "corner", "grouped", "corners", "vector_d", "vector_c",
         "vector_a", "pair", "sync_d", "sync_c"]


def _reference(kind, f):
    """pace_tpu.parallel.halo on the same numpy fields, in its gather
    lowering (the form the port's one-rank path ports; its CopyOp
    lowering equals it, by the reference package's own tests, and takes
    longer to compile)."""
    import jax.numpy as jnp

    from pace_tpu.parallel import copyops
    from pace_tpu.parallel import halo as ref
    from pace_tpu.parallel.topology import get_topology as ref_topology

    mode, copyops.HALO_MODE = copyops.HALO_MODE, "gather"
    try:
        return _reference_calls(kind, f, jnp, ref, ref_topology)
    finally:
        copyops.HALO_MODE = mode


def _reference_calls(kind, f, jnp, ref, ref_topology):

    topo = ref_topology(N_, H)
    j = {k: jnp.asarray(v.numpy()) for k, v in f.items()}
    if kind == "scalar":
        out = [ref.halo_update_scalar(j["q"], topo.scalar_spec("center"))]
    elif kind == "corner":
        out = [ref.halo_update_scalar(j["q"], topo.scalar_spec("corner"))]
    elif kind == "grouped":
        out = ref.halo_update_scalars(topo, [j["q"], j["w"]])
    elif kind == "corners":
        stack = f["stack"].numpy()
        out = [stack[:, s.src_tile, s.src_i, s.src_j]
               for s in topo.scalar_corner_specs()]
    elif kind == "pair":
        out = ref.halo_update_staggered_pair(topo, j["u"], j["v"],
                                             "y_iface", "x_iface")
    elif kind.startswith("sync"):
        out = ref.synchronize_vector_interfaces(topo, j["u"], j["v"],
                                                *STAGGER[kind])
    else:
        out = ref.halo_update_vector(topo, j["u"], j["v"], *STAGGER[kind])
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def fields():
    rng = np.random.RandomState(17)
    N = get_topology(N_, H).N

    def field(*trailing):
        return torch.tensor(rng.randn(6, N, N, *trailing))

    return dict(q=field(NZ), w=field(NZ + 1), u=field(NZ), v=field(NZ),
                stack=torch.tensor(rng.randn(2, 6, N, N, NZ)))


class Loopback:
    """The exchanges of `size` rank threads, routed in this process."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=60)
        self.sent = [None] * size

    def comm(self, rank):
        loop = self

        class Comm:
            def exchange(self, send, send_counts, recv_counts):
                loop.sent[rank] = (send, list(send_counts))
                loop.barrier.wait()
                chunks = []
                for src in range(loop.size):
                    buf, counts = loop.sent[src]
                    start = sum(counts[:rank])
                    chunks.append(buf[start:start + counts[rank]])
                loop.barrier.wait()
                recv = torch.cat(chunks)
                assert recv.shape[0] == sum(recv_counts)
                return recv

        return Comm()


def _on_ranks(partition, fn):
    """fn(rank, RankTopology) in one thread per rank; results by rank."""
    loop = Loopback(partition.size)
    results, errors = [None] * partition.size, []

    def run(rank):
        try:
            topo = halo.RankTopology(partition, rank, loop.comm(rank))
            results[rank] = fn(rank, topo)
        except BaseException as exc:  # reported after the join
            errors.append(exc)
            loop.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(partition.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


def _held(partition, rank, array, lead=0):
    """rank's held part of a global array, non-owned points set to NaN."""
    box = partition.local_box(rank)
    part = (array[:, box.t0:box.t1, box.i0:box.i1, box.j0:box.j1] if lead
            else partition.scatter(array, rank)).clone()
    owned = torch.tensor(partition.owners()[box.index] == rank)
    if lead:
        part[:, ~owned] = float("nan")
    else:
        part[~owned] = float("nan")
    return part


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda s: "x".join(map(str, s)))
def test_rank_exchange_equals_global_gather_and_reference(layout, kind,
                                                          fields):
    partition = Partition(layout, N_, H)
    want = [o if isinstance(o, torch.Tensor) else torch.tensor(o)
            for o in _call(kind, get_topology(N_, H), fields)]
    if layout == (1, 1, 1):
        for got, ref in zip(want, _reference(kind, fields)):
            assert np.array_equal(got.numpy(), ref), kind

    def rank_call(rank, topo):
        held = {k: _held(partition, rank, v, lead=int(k == "stack"))
                for k, v in fields.items()}
        return _call(kind, topo, held)

    lead = int(kind == "corners")
    for rank, outs in enumerate(_on_ranks(partition, rank_call)):
        box = partition.local_box(rank)
        for got, full in zip(outs, want):
            ref = (full[:, box.t0:box.t1, box.i0:box.i1, box.j0:box.j1]
                   if lead else partition.scatter(full, rank))
            assert torch.equal(got, ref), (layout, kind, rank)
            # as the one-rank gather's: the kernels take contiguous tensors
            assert got.is_contiguous(), (layout, kind, rank)


def _remote_edges(partition, rank):
    """Edges of rank's tiles whose neighbour tile lies on another rank."""
    tiles = partition.tiles(rank)
    transforms = get_topology(N_, H).transforms
    return sum(1 for (t, _), tr in transforms.items()
               if t in tiles and tr.neighbor not in tiles)


@pytest.mark.parametrize("layout", LAYOUTS[:4],
                         ids=lambda s: "x".join(map(str, s)))
def test_plans_receive_the_halo_surface(layout):
    """Whole tiles: a centre-scalar exchange fills h * n points per tile
    edge that borders another rank from received rows (4 h n a rank at
    (6, 1, 1)); a source point that two of the rank's tiles read near a
    cube corner is received once; the ranks send what the others
    receive, and a vector exchange carries both components across the
    same edges."""
    partition = Partition(layout, N_, H)
    plans = [halo.RankTopology(partition, r).scalar_spec("center")
             for r in range(partition.size)]
    for rank, plan in enumerate(plans):
        filled = int((plan.gathers[0] >= plan.size).sum())
        assert filled == H * N_ * _remote_edges(partition, rank)
        assert plan.recv_rows <= filled
        assert plan.recv_rows == sum(p.send_counts[rank] for p in plans)
        assert plan.send_counts[rank] == plan.recv_counts[rank] == 0
    if layout == (6, 1, 1):
        assert {p.recv_rows for p in plans} == {4 * H * N_}
        vec = halo.RankTopology(partition, 0).vector_spec("y_iface",
                                                          "x_iface")
        assert H * 4 * N_ * 2 <= vec.recv_rows <= H * 4 * (N_ + 1) * 2


def test_layout_validation():
    from pace_torch.driver.driver import MeshConfig

    for layout in ((4, 1, 1), (5, 1, 1), (0, 1, 1), (1, 1)):
        with pytest.raises(ValueError):
            check_layout(layout)
    with pytest.raises(ValueError, match="dcn_mesh_shape"):
        check_layout((6, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="divide C12"):
        Partition((1, 5, 1), N_)
    # a box narrower than the halo: C12 in 6 parts along y is 2 cells wide
    for layout in ((1, 1, 6), (6, 6, 1)):
        with pytest.raises(ValueError, match="12 x 2|2 x 12"):
            Partition(layout, N_)
        with pytest.raises(ValueError, match="narrower than the halo"):
            MeshConfig(layout=layout).build(N_, H, "cpu")
    assert MeshConfig(layout=(1, 1, 1)).build(N_, H, "cpu") is None
    for layout in ((2, 1, 1), (6, 4, 4), (1, 2, 4), (2, 2, 2)):
        with pytest.raises(RuntimeError, match="torchrun"):
            MeshConfig(layout=layout).build(N_, H, "cpu")


def test_ranks_are_host_major_and_cover_the_cube():
    part = Partition((6, 1, 1), N_, H, dcn_mesh_shape=(2, 1, 1))
    assert [part.tiles(r) for r in range(6)] == [range(t, t + 1)
                                                 for t in range(6)]
    boxes = Partition((2, 2, 2), N_, H, dcn_mesh_shape=(2, 1, 1))
    # one host holds ranks 0-3: tiles 0-2, its four (x, y) blocks
    assert [boxes.coords(r) for r in range(4)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    for layout in LAYOUTS:
        owners = Partition(layout, N_, H).owners()
        assert owners.min() == 0
        assert np.bincount(owners.ravel()).size == np.prod(layout)


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda s: "x".join(map(str, s)))
def test_scatter_then_gather_is_the_identity(layout, fields):
    partition = Partition(layout, N_, H)
    q = fields["q"]
    parts = [partition.scatter(q, r) for r in range(partition.size)]
    assert torch.equal(partition.gather(parts), q)
    numpy_parts = [partition.scatter(q.numpy(), r)
                   for r in range(partition.size)]
    assert np.array_equal(partition.gather(numpy_parts), q.numpy())


@pytest.mark.parametrize("layout", [(1, 2, 4), (6, 4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_edge_tables_scatter_along_their_axis(layout):
    """The grid's (6, N) edge tables: a rank's part is its tiles and its
    held range along the axis the table runs along, and the owned ranges
    gather back to the table."""
    from pace_torch.grid.generation import EDGE_TABLE_AXIS

    partition = Partition(layout, N_, H)
    table = np.random.RandomState(3).randn(6, partition.N)
    for axis in set(EDGE_TABLE_AXIS.values()):
        back = np.full_like(table, np.nan)
        for rank in range(partition.size):
            b, lb = partition.box(rank), partition.local_box(rank)
            lo, hi = (lb.i0, lb.i1) if axis == 1 else (lb.j0, lb.j1)
            part = partition.scatter(table, rank, axis=axis)
            assert np.array_equal(part, table[b.t0:b.t1, lo:hi])
            own = (b.i0, b.i1) if axis == 1 else (b.j0, b.j1)
            back[b.t0:b.t1, own[0]:own[1]] = part[:, own[0] - lo:own[1] - lo]
        assert np.array_equal(back, table)
    with pytest.raises(ValueError, match="axis"):
        partition.scatter(table, 0)


def test_a_ranks_domain():
    """The block each rank holds, as the operators see it: under whole
    tiles the tile's own lines h and h + n on every side; under (1, 2, 2)
    the tile's edge lines on the sides its box shares with the tile and
    none on the sides that border another rank, the held block its box
    and depth = h + 1 lines around it, and its owned compute cells."""
    from pace_torch.utils.gridtools import Domain

    whole = Domain.whole(N_, H)
    for dom in [whole] + [Partition(layout, N_, H).domain(r)
                          for layout in ((2, 1, 1), (6, 1, 1))
                          for r in range(layout[0])]:
        assert (dom.col(H), dom.col(H + N_), dom.row(H), dom.row(H + N_),
                dom.edge_lines(1), dom.edge_lines(2)) == (
            H, H + N_, H, H + N_, (H, H + N_), (H, H + N_))
        assert dom.compute() == (slice(H, H + N_),) * 2
        assert dom.is_whole and dom.col(slice(H, H + N_)) == slice(H, H + N_)
    partition = Partition((1, 2, 2), N_, H)
    assert partition.depth == H + 1
    sw, ne = partition.domain(0), partition.domain(3)
    assert (sw.Ni, sw.Nj, ne.Ni, ne.Nj) == (13, 13, 19, 19)
    # the tile's edge lines the block holds, None where it borders a rank
    assert (sw.col(H), sw.col(H + N_), sw.row(H), sw.row(H + N_)) == (
        H, None, H, None)
    # ne holds storage points [5, 24) along i and j
    assert (ne.col(H), ne.col(H + N_), ne.row(H), ne.row(H + N_)) == (
        None, 10, None, 10)
    assert ne.edge_lines(1) == ne.edge_lines(2) == (H - 5, 10)
    assert sw.compute() == (slice(3, 9), slice(3, 9))
    assert ne.compute(iface_x=True) == (slice(4, 11), slice(4, 10))
    # storage indices mapped into the block, dropped outside it
    assert (ne.col(H + N_), ne.col(H), ne.col(slice(0, 12))) == (
        10, None, slice(0, 7))
    assert ne.col(slice(0, 4)) is None
