"""PyTorch port of alifmm_tpu for NVIDIA GPUs.

Anisotropic travel-time fields (telescoped two-phase line-sweep solver)
and batched Fermat ray tracing, with the sweep written as a hand-made CUDA
kernel for Hopper (``ops/cuda_sweep.py``, ``csrc/sweep.cu``).  Module names
follow the JAX package ``alifmm_tpu``, which stays the reference.
"""

from . import grid, materials, rays, solver, weld_data  # noqa: F401
