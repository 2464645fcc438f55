"""The port's plain batched transport (pace_torch.ops.fvtp2d) against the
reference package's jnp fv_tp_2d and its Pallas kernel in interpret mode,
on the same seeded numpy inputs (N=12, NZ=8, T=3; hord 5/6/8/10).

Tolerance 1e-12, the bar of tests/test_pallas_transport.py: both sides run
the same float64 arithmetic in the same order, up to rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import generate_grid_data
from pace_tpu.ops.fvtp2d import fv_tp_2d
from pace_tpu.ops.pallas import fvtp2d_pallas
from pace_torch.ops import fvtp2d as port_fvtp2d
from pace_torch.parallel.partition import Partition
from pace_torch.testing import TRANSPORT_KEYS, transport_inputs
from pace_torch.utils.gridtools import Domain

N_, H, NZ, T = 12, 3, 8, 3
DOM = Domain.whole(N_, H)
TOL = dict(rtol=1e-12, atol=1e-12)
# the limiter classes: smt5 as bl*br < 0 (5), the other monotone form (6),
# ord 8, and ord 10 (ord-8 limiter, inner passes at 8)
HORDS = [5, 6, 8, 10]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def inputs():
    return transport_inputs(N_, NZ, T)


@pytest.fixture(scope="module")
def jax_grid():
    return generate_grid_data(N_, 79, dtype=jnp.float64)


def _port(inputs, hord):
    args = [torch.as_tensor(inputs[k]) for k in TRANSPORT_KEYS]
    fx, fy = port_fvtp2d.transport_batched(*args, DOM, hord)
    return fx.numpy(), fy.numpy()


@pytest.mark.parametrize("hord", HORDS)
def test_plain_transport_matches_jnp(inputs, jax_grid, hord):
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    fx_ref, fy_ref = jax.jit(jax.vmap(
        lambda q_y, q_x: fv_tp_2d(
            q_y, j["crx"], j["cry"], j["xfx"], j["yfx"], jax_grid, N_, H,
            hord, x_mass_flux=j["xmf"], y_mass_flux=j["ymf"], q_y=q_y,
            q_x=q_x,
        )
    ))(j["q_y"], j["q_x"])
    fx, fy = _port(inputs, hord)
    np.testing.assert_allclose(fx, np.asarray(fx_ref), **TOL)
    np.testing.assert_allclose(fy, np.asarray(fy_ref), **TOL)


@pytest.mark.parametrize("hord", HORDS)
def test_plain_transport_matches_pallas_interpret(inputs, hord):
    j = [jnp.asarray(inputs[k]) for k in TRANSPORT_KEYS]
    fx_ref, fy_ref = fvtp2d_pallas.transport_batched(
        *j, N_, H, hord, interpret=True)
    fx, fy = _port(inputs, hord)
    np.testing.assert_allclose(fx, np.asarray(fx_ref), **TOL)
    np.testing.assert_allclose(fy, np.asarray(fy_ref), **TOL)


def test_port_metrics_match_reference(inputs, jax_grid):
    """The generator's metrics are the reference grid's, bit for bit."""
    hz = jax_grid.horizontal
    for name in ("dxa", "dya", "area"):
        np.testing.assert_array_equal(inputs[name],
                                      np.asarray(getattr(hz, name)))


@pytest.mark.parametrize("hord", HORDS)
def test_kernel_wrapper_takes_every_order(inputs, monkeypatch, hord):
    """The CUDA wrapper launches the kernel at every PPM order the plain
    version computes, with the tile count of its inputs (6, or any count
    a rank holds) and the block's extents and edge lines, and still
    refuses a shape its domain does not give before it launches.  The
    launch itself is recorded instead of made (no card here)."""
    from pace_torch.ops import _cuda

    launched = []
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, dtype, *t, ints=(): launched.append(
                            (name, len(t), ints)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    args = [torch.as_tensor(inputs[k]) for k in TRANSPORT_KEYS]
    fx, fy = port_fvtp2d.transport_batched_cuda(*args, DOM, hord)
    assert fx.shape == fy.shape == args[0].shape
    N = args[0].shape[2]
    lines = (H, H + N_, H, H + N_)
    assert launched == [("fvtp2d", 13, (T, 6, N, N, NZ, *lines, hord))]
    with pytest.raises(ValueError):
        port_fvtp2d.transport_batched_cuda(args[0][:, :, 1:].contiguous(),
                                           *args[1:], DOM, hord)
    assert len(launched) == 1

    def tiles(a, k):
        return (a[:, :k] if a.shape[0] == T else a[:k]).contiguous()

    port_fvtp2d.transport_batched_cuda(*(tiles(a, 3) for a in args), DOM,
                                       hord)
    assert launched[-1] == ("fvtp2d", 13, (T, 3, N, N, NZ, *lines, hord))
    port_fvtp2d.transport_batched_cuda(*(tiles(a, 4) for a in args), DOM,
                                       hord)
    assert launched[-1] == ("fvtp2d", 13, (T, 4, N, N, NZ, *lines, hord))
    # rank 5 of (1, 2, 4): the block of storage points [5, 24) x [2, 13),
    # whose box has the tile's east edge; the tile's edge lines at local
    # i -2 (outside) and 10, j 1 (in its halo) and 13 (outside)
    partition = Partition((1, 2, 4), N_, H)
    dom, box = partition.domain(5), partition.local_box(5)
    port_fvtp2d.transport_batched_cuda(
        *((a[(slice(None),) + box.index] if a.shape[0] == T
           else a[box.index]).contiguous() for a in args), dom, hord)
    assert launched[-1] == ("fvtp2d", 13, (T, 6, 19, 11, NZ, -2, 10, 1, 13,
                                           hord))
    assert len(launched) == 4
