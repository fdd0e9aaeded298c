"""PyTorch port of alifmm_tpu for NVIDIA GPUs.

Anisotropic travel-time fields (telescoped two-phase line-sweep solver)
and batched Fermat ray tracing behind the ``ALI_FMM`` facade (``api.py``),
with the sweep, the ray march, the relaxation wave and the ray times
written as hand-made CUDA kernels for Hopper (``csrc/sweep.cu``,
``csrc/rays.cu``; wrappers in ``ops/``).  Module names follow the JAX
package ``alifmm_tpu``, which stays the reference.
"""

from . import api, grid, materials, rays, solver, weld_data  # noqa: F401
from .api import ALI_FMM  # noqa: F401

# set True to silence the progress bars (utils/progress.py)
tqdm_disable = False
