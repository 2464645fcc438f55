"""Moist heat capacity / virtual potential temperature helpers.

Port of `pace_tpu.ops.moist_cv` (reference ai2cm/pace
fv3core/pace/fv3core/stencils/moist_cv.py: fv_setup,
moist_pt, moist_pkz, moist_pt_last_step) for the 6-water-species (nwat=6)
configuration.
"""

from __future__ import annotations

import torch

from pace_torch.utils import constants


def moist_cv_nwat6(qvapor, qliquid, qrain, qsnow, qice, qgraupel):
    ql = qliquid + qrain
    qs = qice + qsnow + qgraupel
    gz = ql + qs
    cvm = (
        (1.0 - (qvapor + gz)) * constants.CV_AIR
        + qvapor * constants.CV_VAP
        + ql * constants.C_LIQ
        + qs * constants.C_ICE
    )
    return cvm, gz


def set_cappa(qvapor, cvm, r_vir):
    return constants.RDGAS / (constants.RDGAS + cvm / (1.0 + r_vir * qvapor))


def fv_setup(
    qvapor, qliquid, qrain, qsnow, qice, qgraupel, pt, delp, delz,
    moist_phys: bool,
):
    """Returns (q_con, cvm, pkz, cappa, dp1)."""
    if moist_phys:
        cvm, q_con = moist_cv_nwat6(
            qvapor, qliquid, qrain, qsnow, qice, qgraupel
        )
        dp1 = constants.ZVIR * qvapor
        cappa = constants.RDGAS / (constants.RDGAS + cvm / (1.0 + dp1))
        pkz = torch.exp(
            cappa
            * torch.log(
                constants.RDG * delp * pt * (1.0 + dp1) * (1.0 - q_con) / delz
            )
        )
    else:
        q_con = torch.zeros_like(pt)
        cvm = torch.full_like(pt, constants.CV_AIR)
        dp1 = torch.zeros_like(pt)
        cappa = torch.full_like(pt, constants.KAPPA)
        pkz = torch.exp(
            constants.KAPPA * torch.log(constants.RDG * delp * pt / delz)
        )
    return q_con, cvm, pkz, cappa, dp1


def moist_pt(
    qvapor, qliquid, qrain, qsnow, qice, qgraupel, pt, delp, delz, r_vir,
):
    """pt -> virtual potential-density temperature (fv_dynamics pt_adjust).
    Returns (cvm, gz, q_con, cappa, pt)."""
    cvm, gz = moist_cv_nwat6(qvapor, qliquid, qrain, qsnow, qice, qgraupel)
    q_con = gz
    cappa = set_cappa(qvapor, cvm, r_vir)
    pt = pt * torch.exp(
        cappa / (1.0 - cappa) * torch.log(constants.RDG * delp / delz * pt)
    )
    return cvm, gz, q_con, cappa, pt


def moist_pt_last_step(
    qvapor, qliquid, qrain, qsnow, qice, qgraupel, pt, pkz, dtmp, r_vir,
):
    """Convert potential-density temperature back to temperature with the
    diffusive heating increment (remapping last step). Returns (gz, pt)."""
    gz = qliquid + qrain + qice + qsnow + qgraupel
    pt = (pt + dtmp * pkz) / ((1.0 + r_vir * qvapor) * (1.0 - gz))
    return gz, pt


def moist_pkz(
    qvapor, qliquid, qrain, qsnow, qice, qgraupel, pt, delp, delz, r_vir,
):
    """Returns (q_con, gz, cvm, cappa, pkz)."""
    cvm, gz = moist_cv_nwat6(qvapor, qliquid, qrain, qsnow, qice, qgraupel)
    q_con = gz
    cappa = set_cappa(qvapor, cvm, r_vir)
    pkz = torch.exp(cappa * torch.log(constants.RDG * delp / delz * pt))
    return q_con, gz, cvm, cappa, pkz
