"""DriverState: everything the driver steps.

Analogue of ai2cm/pace driver/pace/driver/state.py `DriverState`, holding
the port's dataclasses of tensors.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Any, Optional


@dataclasses.dataclass
class DriverState:
    dycore_state: Any
    grid_data: Any
    sizing: Any
    time: Optional[datetime] = None
