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
    TRANSPORT_KEYS, fillz_inputs, plant_fillz_hazards, sim1_inputs,
    transport_inputs,
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
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(g), test(r))
        fin = torch.isfinite(r)
        err = max(err, float((g[fin] - r[fin]).abs().max()))
        inside = r[region]
        scale = max(scale,
                    float(inside[torch.isfinite(inside)].abs().max()))
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


# many negative columns, few (most columns leave the kernel as a copy), a
# zero or non-finite dp or q planted in columns without negatives, and
# sizes the blocks do not divide (a ragged last block; an even nz, whose
# columns are padded in shared memory; the least nz)
FILLZ_CASES = {
    "dense": lambda: fillz_inputs(9, 24, 24, 79),
    "mostly clean": lambda: fillz_inputs(9, 24, 24, 79, neg_frac=1e-4),
    "planted hazards": lambda: plant_fillz_hazards(
        *fillz_inputs(9, 24, 24, 79, neg_frac=1e-4)),
    "ragged, odd nz": lambda: fillz_inputs(3, 5, 7, 79, neg_frac=0.05),
    "ragged, even nz": lambda: plant_fillz_hazards(
        *fillz_inputs(2, 5, 7, 80, neg_frac=0.05)),
    "nz 3": lambda: fillz_inputs(2, 5, 7, 3),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FILLZ_CASES)
def test_fillz_kernel(cuda, dtype, case):
    from pace_torch.ops import fillz

    q, dp = (torch.as_tensor(a, dtype=dtype, device=cuda)
             for a in FILLZ_CASES[case]())
    plain = torch.stack([fillz.fix_tracer_plain(q[t], dp)
                         for t in range(q.shape[0])])
    bar = 1e-12 if dtype == torch.float64 else 1e-5
    assert _err([fillz.fix_tracers_cuda(q, dp)], [plain]) <= bar
    assert np.isfinite(plain.cpu().numpy()).all() == ("hazards" not in case
                                                      and "even" not in case)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fillz_kernel_unaligned_columns(cuda, dtype):
    """Tensors whose storage starts off a 16-byte boundary: the kernel
    takes narrower copies at the ends of each chunk and agrees all the
    same."""
    from pace_torch.ops import fillz

    q, dp = (torch.as_tensor(a, dtype=dtype, device=cuda)
             for a in fillz_inputs(3, 5, 7, 79, neg_frac=0.05))
    plain = torch.stack([fillz.fix_tracer_plain(q[t], dp)
                         for t in range(q.shape[0])])
    for off_q, off_dp in ((1, 0), (0, 1), (3, 1)):
        q1 = torch.empty(q.numel() + 4, dtype=dtype, device=cuda)
        q1 = q1[off_q:off_q + q.numel()].view(q.shape).copy_(q)
        dp1 = torch.empty(dp.numel() + 4, dtype=dtype, device=cuda)
        dp1 = dp1[off_dp:off_dp + dp.numel()].view(dp.shape).copy_(dp)
        assert q1.data_ptr() % 16 == (off_q * q.element_size()) % 16
        got = fillz.fix_tracers_cuda(q1, dp1)
        assert torch.equal(got, fillz.fix_tracers_cuda(q, dp))
        bar = 1e-12 if dtype == torch.float64 else 1e-5
        assert _err([got], [plain]) <= bar
