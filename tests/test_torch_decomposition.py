"""Ranks that split tiles along x and y, operator by operator, in one
process.

The operators take a `Domain` (utils/gridtools.py): the block of each
tile a rank holds, where its tile-edge forms land only on the lines of the
tile's edges that the block holds.  Each operator on a rank's block must
equal the one-process operator on the points the rank owns, bit for bit
(NaNs at the same places):

- the inputs are those of tests/test_torch_dycore.py's `op_outputs`: the
  port's C12/79 float64 step-1 state with the acoustics entry halo
  updates, the operators applied as tests/golden/op_suite.py applies
  them.  Each rank of (1, 2, 2), (1, 2, 4) and (2, 2, 2) takes its held
  box of those inputs and of the grid (cutting a halo-updated global
  array gives exactly what an exchange would), and each operator is fed
  the one-process values of the operators before it; the ranks run in
  threads whose halo exchanges (tracer advection's, c2l_ord's) are
  routed in this process;
- the plain K-T (`transport_batched_plain`) on each rank's box against the
  reference package's jnp `fv_tp_2d` on the whole cube, run as
  tests/test_torch_transport.py runs it, at its 1e-12 bar.

(1, 2, 4) at C12 gives boxes of 6 x 3 cells: a box of exactly the halo's
width, whose neighbour's halo holds the tile's edge lines.  The
operators' cases are `slow` (the one-process step they share takes 25 s
in a six-worker run, each layout's ranks another 25-35 s); tier 1 holds
the transport at every layout here and the whole step at (1, 2, 2) in
rank processes (tests/test_torch_sharded_step.py)."""

import numpy as np
import pytest
import torch

from pace_torch.grid.generation import GridData, grid_arrays_numpy
from pace_torch.parallel.partition import Partition
from pace_torch.testing import torch_threads
from tests.test_torch_dycore import (
    N_,
    NZ,
    _run,
    apply_op_suite,
    halo_updated_inputs,
)
from tests.test_torch_partition import _on_ranks

H = 3
LAYOUTS = [(1, 2, 2), (1, 2, 4), (2, 2, 2)]
OPS = ["c_sw", "fx_adv", "fv_tp_2d_damped", "xppm_x_flux", "d_sw",
       "update_dz_c", "riem_solver_c", "p_grad_c", "update_dz_d",
       "riem_solver3", "nh_p_grad", "a2b_ord4", "del2_cubed",
       "tracer_advection", "remapping", "c2l_ord4"]


def _ids(layout):
    return "x".join(map(str, layout))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def whole():
    """The one-process operators: their inputs, outputs and the values
    each feeds the next."""
    with torch_threads(3):
        _, core, states = _run(torch.float64, 1)
    s = halo_updated_inputs(core, states[0])
    links = {}
    out = apply_op_suite(dict(s), core.grid_data, core.topo, core.config,
                         core.column_namelist, core.vertical_params, {},
                         links)
    return core, s, links, out


@pytest.fixture(scope="module")
def blocks(whole):
    """layout -> (partition, each rank's operator outputs), computed once a
    layout."""
    core, s, links, _ = whole
    arrays = grid_arrays_numpy(N_, NZ)
    done = {}

    def cut(value, partition, rank):
        if isinstance(value, (tuple, list)):
            return type(value)(cut(v, partition, rank) for v in value)
        if isinstance(value, torch.Tensor) and value.ndim >= 3:
            return partition.scatter(value, rank)
        return value

    def run(layout):
        if layout not in done:
            partition = Partition(layout, N_, H)

            def rank_ops(rank, topo):
                with torch_threads(1):
                    grid = GridData.from_numpy(
                        arrays, "cpu", torch.float64,
                        scatter=partition.part(rank).cut)
                    return apply_op_suite(
                        {k: cut(v, partition, rank) for k, v in s.items()},
                        grid, topo,
                        core.config, core.column_namelist,
                        core.vertical_params, {},
                        {k: cut(v, partition, rank)
                         for k, v in links.items()})

            done[layout] = partition, _on_ranks(partition, rank_ops)
        return done[layout]

    return run


def _owned(partition, rank):
    """(global, local) index of the compute-domain cells and interfaces
    that `rank` owns."""
    b, lb = partition.box(rank), partition.local_box(rank)
    gi = slice(max(b.i0, H), min(b.i1, H + N_ + 1))
    gj = slice(max(b.j0, H), min(b.j1, H + N_ + 1))
    li = slice(gi.start - lb.i0, gi.stop - lb.i0)
    lj = slice(gj.start - lb.j0, gj.stop - lb.j0)
    return (slice(b.t0, b.t1), gi, gj), (slice(None), li, lj)


@pytest.mark.slow
@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
@pytest.mark.parametrize("op", OPS)
def test_operator_on_a_ranks_block_equals_one_process(whole, blocks, op,
                                                      layout):
    ref = whole[3][op]
    partition, outs = blocks(layout)
    for rank, out in enumerate(outs):
        glob, loc = _owned(partition, rank)
        for name, want in ref.items():
            got = out[op][name][loc].numpy()
            want = want[glob].numpy()
            assert np.array_equal(got, want, equal_nan=True), (
                f"rank {rank} {op}.{name}: max diff "
                f"{np.nanmax(np.abs(got - want))}")


HORD = 8


@pytest.fixture(scope="module")
def transport_reference():
    """Seeded transport inputs and the reference package's jnp fluxes of
    them on the whole cube."""
    import jax
    import jax.numpy as jnp

    from pace_tpu.grid.generation import generate_grid_data
    from pace_tpu.ops.fvtp2d import fv_tp_2d
    from pace_torch.testing import transport_inputs

    inputs = transport_inputs(N_, 8, 2)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    grid = generate_grid_data(N_, 79, dtype=jnp.float64)
    fluxes = jax.jit(jax.vmap(
        lambda q_y, q_x: fv_tp_2d(
            q_y, j["crx"], j["cry"], j["xfx"], j["yfx"], grid, N_, H, HORD,
            x_mass_flux=j["xmf"], y_mass_flux=j["ymf"], q_y=q_y, q_x=q_x)
    ))(j["q_y"], j["q_x"])
    return inputs, [np.asarray(f) for f in fluxes]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_plain_transport_on_blocks_matches_the_reference(
        transport_reference, layout):
    """K-T's plain version on each rank's held box, hord 8, against the
    reference package's jnp transport on the whole cube, on the points
    the rank owns."""
    from pace_torch.ops.fvtp2d import transport_batched_plain
    from pace_torch.testing import TRANSPORT_KEYS

    inputs, (fx_ref, fy_ref) = transport_reference
    partition = Partition(layout, N_, H)
    for rank in range(partition.size):
        box = partition.local_box(rank).index
        args = [torch.as_tensor(inputs[k][(slice(None),) + box]
                                if k in ("q_y", "q_x") else inputs[k][box])
                for k in TRANSPORT_KEYS]
        fx, fy = transport_batched_plain(*args, partition.domain(rank),
                                         HORD)
        glob, loc = _owned(partition, rank)
        for got, want in ((fx, fx_ref), (fy, fy_ref)):
            np.testing.assert_allclose(
                got[(slice(None),) + loc].numpy(),
                want[(slice(None),) + glob], rtol=1e-12, atol=1e-12)
