from pace_torch.models.coupler.update_atmos_state import (  # noqa: F401
    DycoreToPhysics,
    UpdateAtmosphereState,
)
