"""Each hand-written CUDA kernel of pace_torch against its plain PyTorch
version on the card, at C12 shapes, float64 and float32 (the comparisons
of chip_smoke.py phase 2).  These need an NVIDIA GPU with nvcc; elsewhere
they skip.  On the card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Bars: float64 1e-12 of the output scale (the kernels are built without
multiply-add contraction, so they round like the plain versions); float32
1e-5 for transport and fillz; for SIM1 the kernel's float32 error against
the float64 result at most 3x the plain version's + 1e-6."""

import numpy as np
import pytest
import torch

from pace_torch.testing import (
    TRANSPORT_KEYS, fillz_inputs, sim1_inputs, transport_inputs,
)

pytestmark = pytest.mark.gpu
N_, H = 12, 3
DTYPES = [torch.float64, torch.float32]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    from pace_torch.ops import _cuda

    _cuda.library()
    return torch.device("cuda")


def _err(got, ref, region=...):
    """Largest |got - ref| over finite points / max |ref| over region;
    non-finite values must coincide."""
    err, scale = 0.0, 0.0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        assert torch.equal(torch.isfinite(g), torch.isfinite(r))
        fin = torch.isfinite(r)
        err = max(err, float((g[fin] - r[fin]).abs().max()))
        scale = max(scale, float(r[region].abs().max()))
    return err / (scale + 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,nz,hord", [(8, 79, 8), (3, 79, 6), (1, 80, 6),
                                       (3, 79, 5), (3, 79, 10)])
def test_transport_kernel(cuda, dtype, T, nz, hord):
    from pace_torch.ops import fvtp2d

    arrays = transport_inputs(N_, nz, T)
    args = [torch.as_tensor(arrays[k], dtype=dtype, device=cuda)
            for k in TRANSPORT_KEYS]
    plain = fvtp2d.transport_batched_plain(*args, N_, H, hord)
    kern = fvtp2d.transport_batched_cuda(*args, N_, H, hord)
    region = (slice(None),) * 2 + (slice(H, H + N_ + 1),) * 2
    bar = 1e-12 if dtype == torch.float64 else 1e-5
    assert _err(kern, plain, region) <= bar


def test_sim1_kernel(cuda):
    from pace_torch.ops import riemann

    arrays = sim1_inputs(24, 24, 79)
    x64 = [torch.as_tensor(a, device=cuda) for a in arrays]
    truth = riemann.sim1_solver_plain(*x64, 225.0, 0.05)
    assert _err(riemann.sim1_solver_cuda(*x64, 225.0, 0.05), truth) <= 1e-12
    x32 = [t.float() for t in x64]
    plain = riemann.sim1_solver_plain(*x32, 225.0, 0.05)
    kern = riemann.sim1_solver_cuda(*x32, 225.0, 0.05)
    for t, p, k in zip(truth, plain, kern):
        assert _err([k], [t]) <= 3.0 * _err([p], [t]) + 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
def test_fillz_kernel(cuda, dtype):
    from pace_torch.ops import fillz

    q, dp = (torch.as_tensor(a, dtype=dtype, device=cuda)
             for a in fillz_inputs(9, 24, 24, 79))
    plain = torch.stack([fillz.fix_tracer_plain(q[t], dp)
                         for t in range(q.shape[0])])
    bar = 1e-12 if dtype == torch.float64 else 1e-5
    assert _err([fillz.fix_tracers_cuda(q, dp)], [plain]) <= bar
    assert np.isfinite(plain.cpu().numpy()).all()
