"""PyTorch / CUDA port of the JAX package, for NVIDIA Hopper.

Subpackages mirror the JAX package: `ops/` (plain ops and the hand-written
kernels), `models/`, `sampling/`, `utils/`; `weights.py` carries JAX
parameter trees across and makes seeded weights.
"""
