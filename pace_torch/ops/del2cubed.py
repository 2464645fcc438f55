"""Hyperdiffusion (del2_cubed) Laplacian filter.

Port of `pace_tpu.ops.del2cubed` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/del2cubed.py
`HyperdiffusionDamping`.
"""

from __future__ import annotations

from pace_torch.ops import corners as corner_ops
from pace_torch.ops import stencil_utils as su
from pace_torch.ops.stencil_utils import shift


def _corner_fill(q, dom):
    """Average the 3 cells meeting at each cube corner into all three
    locations (del2cubed.py corner_fill)."""
    n, h = dom.n, dom.h
    third = 1.0 / 3.0
    isc, iec = h, h + n - 1
    jsc, jec = h, h + n - 1
    out = q
    updates = [
        # (target, (three source cells))
        ((isc, jsc), ((0, 0), (-1, 0), (0, -1))),
        ((isc - 1, jsc), ((1, 0), (0, 0), (1, -1))),
        ((isc, jsc - 1), ((0, 1), (-1, 1), (0, 0))),
        ((iec, jsc), ((0, 0), (1, 0), (0, -1))),
        ((iec + 1, jsc), ((-1, 0), (0, 0), (-1, -1))),
        ((iec, jsc - 1), ((0, 1), (1, 1), (0, 0))),
        ((iec, jec), ((0, 0), (1, 0), (0, 1))),
        ((iec + 1, jec), ((-1, 0), (0, 0), (-1, 1))),
        ((iec, jec + 1), ((0, -1), (1, -1), (0, 0))),
        ((isc, jec), ((0, 0), (-1, 0), (0, 1))),
        ((isc - 1, jec), ((1, 0), (0, 0), (1, 1))),
        ((isc, jec + 1), ((0, -1), (-1, -1), (0, 0))),
    ]
    for (ti, tj), offs in updates:
        expr = sum(su.shift(q, oi, oj) for (oi, oj) in offs) * third
        out = su.upd_point(dom, out, expr, ti, tj)
    return out


def hyperdiffusion(qdel, gd, cd, dom, nmax=3):
    """Apply ntimes=min(3, nmax) del-2 filter passes to qdel."""
    del6_u = gd.damping.del6_u[..., None]
    del6_v = gd.damping.del6_v[..., None]
    rarea = gd.horizontal.rarea[..., None]
    ntimes = int(min(3, nmax))
    for _ in range(ntimes):
        q = _corner_fill(qdel, dom)
        qx = corner_ops.copy_corners(q, dom, "x")
        fx = del6_v * (shift(qx, -1) - qx)
        qy = corner_ops.copy_corners(qx, dom, "y")
        fy = del6_u * (shift(qy, 0, -1) - qy)
        qdel = qy + cd * rarea * (fx - shift(fx, 1) + fy - shift(fy, 0, 1))
    return qdel
