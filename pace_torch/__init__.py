"""pace_torch: the FV3 dynamical core in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package `pace_tpu` (which stays the numerical
reference).  It keeps that package's module paths and array layout
(6, N, N[, nz]); it imports torch and never jax.

Public API, the same names as `pace_tpu`'s:

    from pace_torch import (
        DynamicalCore, DynamicalCoreConfig, DycoreState,
        Physics, PhysicsConfig, PhysicsState,
        Driver, DriverConfig,
        GridSizing, generate_grid_data, Quantity,
    )
"""

import importlib

__version__ = "0.1.0"

# name -> module that defines it; imported on first use, so that
# `import pace_torch` stays light
_EXPORTS = {
    "DynamicalCore": "pace_torch.models.fv3.dynamics",
    "DynamicalCoreConfig": "pace_torch.models.fv3.config",
    "DycoreState": "pace_torch.models.fv3.state",
    "Physics": "pace_torch.models.physics.physics",
    "PhysicsConfig": "pace_torch.models.physics.config",
    "PhysicsState": "pace_torch.models.physics.physics_state",
    "Driver": "pace_torch.driver.driver",
    "DriverConfig": "pace_torch.driver.driver",
    "GridSizing": "pace_torch.utils.gridtools",
    "generate_grid_data": "pace_torch.grid.generation",
    "Quantity": "pace_torch.utils.quantity",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'pace_torch' has no attribute {name!r}")
