from pace_torch.driver.driver import Driver, DriverConfig  # noqa: F401
from pace_torch.driver.initialization import (  # noqa: F401
    BaroclinicInit,
    InitializerSelector,
)
