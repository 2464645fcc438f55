"""Pair-debug in the port (utils/pair_debug.py): the cases of
tests/test_util_components.py `test_pair_debug` against
`pace_tpu.utils.pair_debug` on the same inputs.  The port's second
placement runs the function on the tiles of each rank of a (6, 1, 1)
layout, one rank after another in this process (no halo exchange), and
gathers the outputs; the reference's shards over a (6, 1, 1) mesh.  A
planted mismatch raises in both, with the same per-leaf report, and NaNs
at the same places count as equal."""

import dataclasses

import numpy as np
import pytest
import torch

from pace_torch.parallel.partition import Partition
from pace_torch.utils.pair_debug import (
    PairDebugMismatch,
    compare_under_placements,
    layout_placement,
    replicated,
)


def _x():
    return np.arange(6 * 8 * 8 * 2, dtype=np.float32).reshape(6, 8, 8, 2)


def test_layout_placement_equals_replicated_as_in_the_reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from pace_tpu.utils import pair_debug as ref

    devices = np.array(jax.devices()[:6]).reshape(6, 1, 1)
    mesh = Mesh(devices, ("tile", "x", "y"))
    want = ref.compare_under_shardings(
        lambda x: x * 2.0 + jnp.roll(x, 1, axis=1), (jnp.asarray(_x()),),
        ref.replicated, ref.mesh_placement(mesh, P("tile", "x", "y")))
    # a (6, N, N) layout with N = 8: C1 with a halo of 3
    got = compare_under_placements(
        lambda x: x * 2.0 + torch.roll(x, 1, dims=1),
        (torch.tensor(_x()),), replicated,
        layout_placement(Partition((6, 1, 1), 1, 3)))
    assert got == want == {"0": 0.0}


def test_a_planted_mismatch_raises_with_the_reference_report():
    from pace_tpu.utils import pair_debug as ref

    import jax.numpy as jnp

    with pytest.raises(ref.PairDebugMismatch) as ref_err:
        ref.compare_under_shardings(
            lambda x: x, (jnp.asarray(_x()),), ref.replicated,
            lambda args: tuple(a + 1.0 for a in args))
    with pytest.raises(PairDebugMismatch) as err:
        compare_under_placements(
            lambda x: x, (torch.tensor(_x()),), replicated,
            lambda fn, args: tuple(fn(*args)[None] + 1.0))
    assert str(err.value) == str(ref_err.value)
    # a function that reads another tile differs under the layout
    with pytest.raises(PairDebugMismatch, match="0: max err"):
        compare_under_placements(
            lambda x: x + torch.roll(x, 1, dims=0), (torch.tensor(_x()),),
            replicated, layout_placement(Partition((2, 1, 1), 1, 3)))


def test_dataclass_leaves_nan_equal_and_window():
    @dataclasses.dataclass
    class Pair:
        a: torch.Tensor
        b: torch.Tensor

    x = torch.tensor(_x()).double()
    x[2, 4, 4, 0] = float("nan")

    def fn(q):
        return Pair(q * 3.0, q.sum(-1))

    report = compare_under_placements(
        fn, (x,), replicated, layout_placement(Partition((3, 1, 1), 1, 3)))
    assert report == {"a": 0.0, "b": 0.0}
    shifted = compare_under_placements(
        fn, (x,), replicated, lambda f, args: Pair(f(*args).a + 0.5,
                                                   f(*args).b),
        atol=1.0, window=lambda a: a[:, 3:5, 3:5])
    assert shifted == {"a": 0.5, "b": 0.0}


@pytest.mark.parametrize("layout", [(1, 2, 2), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_layout_placement_splits_tiles_along_x_and_y(layout):
    """Under an x/y layout the placement hands each rank its block: the
    state's fields cut to its held box, the grid with its edge tables cut
    along their own axes, the rank's Domain; the ranks' owned boxes,
    gathered, equal the whole cube's result (here a2b_ord4 and d2a2c,
    whose tile-edge forms and corner fills need no halo update on these
    inputs)."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.ops.a2b_ord4 import a2b_ord4
    from pace_torch.ops.d2a2c import d2a2c_vect
    from pace_torch.utils.gridtools import Domain, GridSizing

    sizing = GridSizing(12, 5)
    grid = generate_grid_data(12, 79, device="cpu", dtype=torch.float64)
    state = init_baroclinic_state(GridSizing(12, 79), device="cpu",
                                  dtype=torch.float64)

    def fn(pt, u, v, grid, dom):
        return (a2b_ord4(pt, grid, dom),) + d2a2c_vect(u, v, grid, dom)

    report = compare_under_placements(
        fn, (state.pt[..., :sizing.nz], state.u[..., :sizing.nz],
             state.v[..., :sizing.nz], grid, Domain.whole(12)),
        replicated, layout_placement(Partition(layout, 12)))
    assert report == {str(i): 0.0 for i in range(7)}
