"""PyTorch port of alifmm_tpu for NVIDIA GPUs.

Anisotropic travel-time fields (telescoped two-phase line-sweep solver)
and batched Fermat ray tracing behind the ``ALI_FMM`` facade (``api.py``),
with the hot loops written as hand-made CUDA kernels for Hopper (wrappers
in ``ops/``): the sweep pass K1 and the halo solves' slab sweep K5
(``csrc/sweep.cu``), the plane-search ray march K2 and the relaxation
waves with the ray times K3 (``csrc/rays.cu``), and the descent march K4
(``csrc/descent.cu``; K2-K4 share ``csrc/ray_device.cuh``).  Each kernel
has a plain PyTorch twin, which runs on CPU tensors.  ``parallel/``
splits sources or the grid over devices and processes (``Mesh``,
``shard``, ``multihost``).  Module names follow the JAX package
``alifmm_tpu``, which stays the reference.
"""

from . import api, grid, materials, rays, solver, weld_data  # noqa: F401
from .api import ALI_FMM  # noqa: F401

# set True to silence the progress bars (utils/progress.py)
tqdm_disable = False
