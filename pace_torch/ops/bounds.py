"""The bound model of the hand-written kernels, and their cost count.

The least time the card could take for a kernel's work is the larger of
the bytes it must move (each input read once, each output written once)
over the HBM rate and its operations over the float32 rate.  `chip_smoke.py`
holds each kernel's measured time against this bound, and
`python -m pace_torch.driver.tools cost` counts each kernel call of a step
with the same model: every kernel wrapper (fvtp2d.transport_batched,
riemann.sim1_solver, fillz.fix_tracers) reports its call through
`kernel_call`, on the card and on the CPU alike, so the ops of a CPU
tensor's plain version are not counted and the two devices' counts agree.
"""

from __future__ import annotations

import contextlib

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per output value, counted from the plain versions' formulas
# (an add, multiply, divide, compare, min/max, abs or transcendental is
# one): K-T per field and point, 4 PPM cells (slope, interface value,
# limited edges: 27 each), 4 fluxes (9), 2 advected values (7) and 2 flux
# combinations (3); K-S per level, about 60 plus 4 transcendentals; K-F
# per level, about 20.
OPS_PER_POINT = {"K-T": 4 * 27 + 4 * 9 + 2 * 7 + 2 * 3, "K-S": 64,
                 "K-F": 20}

KERNELS = {
    "K-T": dict(name="fvtp2d transport_batched",
                source="pace_torch/csrc/fvtp2d.cu",
                replaces="pace_tpu/ops/pallas/fvtp2d_pallas.py:217"),
    "K-S": dict(name="sim1 solver", source="pace_torch/csrc/sim1.cu",
                replaces="pace_tpu/ops/pallas/sim1_pallas.py:202"),
    "K-F": dict(name="fillz fix_tracer", source="pace_torch/csrc/fillz.cu",
                replaces="pace_tpu/ops/pallas/fillz_pallas.py:135"),
}


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def optimal_seconds(nbytes_moved: float, ops: float) -> float:
    """The larger of bytes over the HBM rate and ops over the f32 rate."""
    return max(nbytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def bound(name, inputs, outputs, points) -> tuple:
    """(bound_ms, bound_by) of one call of kernel `name`: `points` output
    values of OPS_PER_POINT[name] operations each."""
    moved = nbytes((*inputs, *outputs))
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = points * OPS_PER_POINT[name] / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


# The cost count in progress (driver/tools.py's OpCounter), or None.
COUNTER = None


@contextlib.contextmanager
def kernel_call(name: str):
    """Wraps one call of kernel `name` in its wrapper.  The body calls the
    yielded `report(inputs, outputs, points)`; with a count in progress,
    the ops inside are not counted and the call is counted once with the
    bound model's bytes and operations."""
    counter = COUNTER
    if counter is None:
        yield lambda inputs, outputs, points: None
        return
    reported = []
    counter.suspended += 1
    try:
        yield lambda inputs, outputs, points: reported.append(
            (nbytes((*inputs, *outputs)), points * OPS_PER_POINT[name]))
    finally:
        counter.suspended -= 1
    for moved, ops in reported:
        counter.add_kernel(name, moved, ops)
