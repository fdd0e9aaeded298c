"""A correctly rounded square root for the plain twins.

PyTorch's CPU ``torch.sqrt`` is not the IEEE square root: its
vectorised path differs from it by one ulp on about 0.9 % of float64
inputs (``sqrt(2.0)`` gives ``0x1.6a09e667f3bccp+0``, not ``...bcdp+0``)
and on about 0.7 % of float32 ones.  The JAX package, numpy,
``math.sqrt`` and CUDA's ``sqrt`` (which the kernels run) all round
correctly, and the solver's stencil choices can amplify one ulp into a
visible difference.  So every twin takes its roots from ``sqrt`` here.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt(x)``, correctly rounded on CPU tensors.

    On the CPU the root is numpy's (the hardware's IEEE instruction),
    written into a tensor of ``x``'s dtype and shape.  On other devices it
    is ``torch.sqrt``: CUDA's is correctly rounded already, and the graphed
    twin (``ops/sweep.gs_pass(graphed=True)``) captures it in a CUDA graph,
    which allows no host copy.
    """
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x)
    with np.errstate(invalid="ignore"):    # NaN below 0, as torch.sqrt
        np.sqrt(x.detach().numpy(), out=out.numpy())
    return out
