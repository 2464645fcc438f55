"""State sanity checking between timesteps.

Port of `pace_tpu.driver.safety_checks` (reference ai2cm/pace
driver/pace/driver/safety_checks.py `SafetyChecker` / `VariableBounds`):
registered per-variable bounds, checked against the DycoreState;
violations raise RuntimeError.  The minima and maxima are reduced on the
device and read back together, a few scalars, in one transfer; over the
ranks of a multi-rank run (a `comm`, parallel/comm.py) they are reduced by
one more collective, so every rank checks the whole cube's extrema.
"""

from __future__ import annotations

from typing import ClassVar, Dict, Optional

import torch

from pace_torch.utils.gridtools import Domain
from pace_torch.utils.host import to_host


class VariableBounds:
    def __init__(self, minimum_value: Optional[float] = None,
                 maximum_value: Optional[float] = None,
                 compute_domain_only: bool = False) -> None:
        self.minimum_value = minimum_value
        self.maximum_value = maximum_value
        self.compute_domain_only = compute_domain_only


class SafetyChecker:
    """Checks registered state variables against bounds.

    Raises:
        NotImplementedError: doubly-registered variables or variables
            missing from the state
        RuntimeError: variables outside the specified bounds
    """

    checks: ClassVar[Dict[str, VariableBounds]] = {}

    def __init__(self, sizing=None, comm=None, domain=None):
        """`domain`: the block of each tile the checked states hold (a
        rank's, under a layout that splits tiles); the whole tile by
        default."""
        self.sizing = sizing
        self.comm = comm
        self.domain = domain or (Domain.whole(sizing.n, sizing.halo)
                                 if sizing is not None else None)

    @classmethod
    def register_variable(cls, name: str,
                          minimum_value: Optional[float] = None,
                          maximum_value: Optional[float] = None,
                          compute_domain_only: bool = False):
        if name in cls.checks:
            raise NotImplementedError("Can only register variables once")
        cls.checks[name] = VariableBounds(
            minimum_value, maximum_value, compute_domain_only
        )

    @classmethod
    def clear_all_checks(cls):
        cls.checks.clear()

    def check_state(self, state):
        extrema = {}
        for variable, bounds in self.checks.items():
            if not hasattr(state, variable):
                raise NotImplementedError(
                    f"Variable {variable} is not in the state"
                )
            arr = getattr(state, variable)
            if bounds.compute_domain_only and self.domain is not None:
                # the compute cells this rank owns
                arr = arr[(slice(None),) + self.domain.compute()]
            # (min, -max): both reduce as minima over ranks
            extrema[variable] = torch.stack([arr.min(), -arr.max()])
        if self.comm is not None and extrema:
            names = list(extrema)
            both = self.comm.all_reduce(
                torch.stack([extrema[v] for v in names]), "min")
            extrema = dict(zip(names, both))
        for variable, (min_val, neg_max) in to_host(extrema).items():
            bounds = self.checks[variable]
            min_val, max_val = float(min_val), -float(neg_max)
            if bounds.minimum_value is not None \
                    and min_val < bounds.minimum_value:
                raise RuntimeError(
                    f"Variable {variable} is outside of its specified "
                    f"bounds: {min_val} < {bounds.minimum_value}"
                )
            if bounds.maximum_value is not None \
                    and max_val > bounds.maximum_value:
                raise RuntimeError(
                    f"Variable {variable} is outside of its specified "
                    f"bounds: {max_val} > {bounds.maximum_value}"
                )


def register_default_checks():
    """The driver's bounds on pt, delp, u and v (reference package
    driver.py:395-412); registered once per process."""
    if SafetyChecker.checks:
        return
    SafetyChecker.register_variable(
        "pt", minimum_value=150.0, maximum_value=350.0,
        compute_domain_only=True,
    )
    SafetyChecker.register_variable(
        "delp", minimum_value=0.01, compute_domain_only=True
    )
    SafetyChecker.register_variable(
        "u", minimum_value=-250.0, maximum_value=250.0,
        compute_domain_only=True,
    )
    SafetyChecker.register_variable(
        "v", minimum_value=-250.0, maximum_value=250.0,
        compute_domain_only=True,
    )
