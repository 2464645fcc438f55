"""pace_torch: the FV3 dynamical core in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package `pace_tpu` (which stays the numerical
reference).  It keeps that package's module paths and array layout
(6, N, N[, nz]); it imports torch and never jax.
"""

__version__ = "0.1.0"
