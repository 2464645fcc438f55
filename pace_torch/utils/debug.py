"""Numerical debug hooks.

Port of `pace_tpu.utils.debug`.  `PACE_DEBUG_NANCHECK=1` turns on
per-stage finiteness checking in the model step: after each major op of
fv_dynamics the compute domain of the stage's outputs is read to the host
and checked, and the first offending (stage, field) is reported — the
analogue of the reference's injected SDFG NaN-checker debug pass (ai2cm/pace
dsl/pace/dsl/dace/sdfg_debug_passes.py:247 sdfg_nan_checker).

`PACE_DEBUG_STATECHECK=1` additionally enables the reference's other two
injectable sanitizers (sdfg_debug_passes.py:185 negative_delp_checker,
:211 negative_qtracers_checker): a `delp` passed to `statecheck` must be
strictly non-negative, and any field named like a tracer (q*) must stay
above -1e-8 — the same threshold the reference asserts.  Statecheck
implies the finiteness check on every field it receives.

Only the compute cells a rank owns are checked: halo-padding cells
legitimately hold NaN mid-step.  When the variables are unset the hooks return at once: no
host read and no device work.
"""

from __future__ import annotations

import os

import numpy as np

from pace_torch.utils.host import to_host

NANCHECK_ENABLED = os.environ.get("PACE_DEBUG_NANCHECK", "0") == "1"
STATECHECK_ENABLED = os.environ.get("PACE_DEBUG_STATECHECK", "0") == "1"

# tracer names per the reference's negative_qtracers_checker whitelist
# (sdfg_debug_passes.py:211-228) and its assert threshold (:238)
_TRACER_NAMES = frozenset(
    ("qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel", "qo3mr",
     "qsgs_tke", "qcld")
)
_TRACER_NEG_TOL = -1e-8


class NaNDetected(RuntimeError):
    pass


class NegativeValueDetected(RuntimeError):
    pass


def _interior(a, dom):
    """The compute cells of `dom` (utils/gridtools.py Domain) that the
    rank owns: halo rows, the row at h+n and the corner-wedge point
    (h+n, h+n) legitimately hold NaN mid-step.  No Domain: `a` is cut
    already."""
    if dom is not None and a.ndim >= 3:
        si, sj = dom.compute()
        return a[:, si, sj]
    return a


def _check(stage: str, name: str, a: np.ndarray) -> None:
    if not np.isfinite(a).all():
        count = int((~np.isfinite(a)).sum())
        raise NaNDetected(
            f"non-finite values after stage {stage!r}: field {name!r} "
            f"has {count} bad points (of {a.size})"
        )
    if not STATECHECK_ENABLED:
        return
    if name.startswith("delp"):
        if (a < 0.0).any():
            count = int((a < 0.0).sum())
            raise NegativeValueDetected(
                f"negative delp after stage {stage!r}: field {name!r} "
                f"has {count} points < 0 (min {float(a.min()):.3e})"
            )
    elif name in _TRACER_NAMES:
        if (a < _TRACER_NEG_TOL).any():
            count = int((a < _TRACER_NEG_TOL).sum())
            raise NegativeValueDetected(
                f"negative tracer after stage {stage!r}: field {name!r} "
                f"has {count} points < {_TRACER_NEG_TOL} "
                f"(min {float(a.min()):.3e})"
            )


def _host_check(stage: str, dom, names, *arrays) -> None:
    for name, arr in zip(names, arrays):
        _check(stage, name, _interior(np.asarray(arr), dom))


def statecheck(stage: str, dom, **arrays) -> None:
    """Check the given tensors for finiteness, negative delp and negative
    tracers on the compute cells `dom` owns (the whole tile's in one
    process, the rank's part of them on a rank of a split layout).

    No-op unless PACE_DEBUG_NANCHECK=1 or PACE_DEBUG_STATECHECK=1 was set
    at import time.  The negative-value checks apply only under
    PACE_DEBUG_STATECHECK=1 and only to fields named `delp*` or like a
    tracer, matching the reference's injected checkers.
    """
    if not (NANCHECK_ENABLED or STATECHECK_ENABLED):
        return
    host = to_host({k: _interior(v, dom) for k, v in arrays.items()})
    _host_check(stage, None, tuple(host), *host.values())


# the original finiteness-only entry point; a statecheck alias so the
# negative-value checks ride on the same per-stage hooks
nancheck = statecheck
