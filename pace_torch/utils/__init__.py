from pace_torch.utils import constants
from pace_torch.utils.gridtools import GridSizing
from pace_torch.utils.quantity import Quantity, QuantityFactory
from pace_torch.utils.timing import NullTimer, Timer

__all__ = [
    "constants", "GridSizing", "Quantity", "QuantityFactory", "Timer",
    "NullTimer",
]
