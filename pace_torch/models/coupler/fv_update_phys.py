"""Apply physics tendencies to the dycore state (fv_update_phys).

Port of `pace_tpu.models.coupler.fv_update_phys` (reference ai2cm/pace
stencils/pace/stencils/fv_update_phys.py `ApplyPhysicsToDycore`):
moist-heat-capacity-consistent temperature update,
hydrostatic pressure rebuild, A->D wind tendency application, and the
final cubed-to-latlon diagnostic winds.
"""

from __future__ import annotations

import torch

from pace_torch.models.coupler.update_dwind_phys import update_dwind_phys
from pace_torch.ops import c2l_ord
from pace_torch.ops.stencil_utils import cumsum_k, maximum
from pace_torch.utils import constants as con


def moist_cv_apply_t_dt(qvapor, qliquid, qrain, qsnow, qice, qgraupel, pt,
                        t_dt, dt):
    """pt += t_dt*dt*cp/cvm with the nwat=6 moist heat capacity
    (reference fv_update_phys.py:19-49)."""
    ql = qliquid + qrain
    qs = qice + qsnow + qgraupel
    gz = ql + qs
    cvm = (
        (1.0 - (qvapor + gz)) * con.CV_AIR + qvapor * con.CV_VAP
        + ql * con.C_LIQ + qs * con.C_ICE
    )
    return pt + t_dt * dt * con.CP_AIR / cvm


def update_pressure_and_surface_winds(pe, delp, peln, pk, ua, va):
    """Rebuild interface pressures from delp (reference
    fv_update_phys.py:52-76).  Returns (pe, peln, pk, ps, u_srf, v_srf)."""
    pe = torch.cat(
        [pe[..., :1], pe[..., :1] + cumsum_k(delp)], -1
    )
    # clamp: padded columns carry pe=0 which would give log(0) = -inf
    peln_new = torch.log(maximum(pe[..., 1:], 1.0e-10))
    peln = torch.cat([peln[..., :1], peln_new], -1)
    pk = torch.cat([pk[..., :1], torch.exp(con.KAPPA * peln_new)], -1)
    ps = pe[..., -1]
    u_srf = ua[..., -1]
    v_srf = va[..., -1]
    return pe, peln, pk, ps, u_srf, v_srf


def apply_physics_to_dycore(s: dict, u_dt, v_dt, t_dt, gd, topo,
                            c2l_order, dt):
    """Mutates the dycore state dict s; returns (s, u_srf, v_srf).
    Mirrors ApplyPhysicsToDycore.__call__ (fv_update_phys.py:150-192)."""
    s = dict(s)
    s["pt"] = moist_cv_apply_t_dt(
        s["qvapor"], s["qliquid"], s["qrain"], s["qsnow"], s["qice"],
        s["qgraupel"], s["pt"], t_dt, dt,
    )
    (s["pe"], s["peln"], s["pk"], s["ps"], u_srf, v_srf) = (
        update_pressure_and_surface_winds(
            s["pe"], s["delp"], s["peln"], s["pk"], s["ua"], s["va"]
        )
    )
    s["u"], s["v"] = update_dwind_phys(
        s["u"], s["v"], u_dt, v_dt, gd, topo, dt
    )
    ua, va, u, v = c2l_ord.cubed_to_latlon(
        s["u"], s["v"], gd, topo, order=c2l_order
    )
    s["ua"], s["va"], s["u"], s["v"] = ua, va, u, v
    return s, u_srf, v_srf
