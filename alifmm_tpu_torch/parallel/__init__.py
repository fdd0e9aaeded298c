"""Scale-out of the port: the device mesh, the sharded solves
(``shard``) and the process group (``multihost``).

Counterpart of ``alifmm_tpu/parallel``.  PyTorch has no
``jax.sharding.Mesh``, so ``Mesh`` here is a small class: an array of
``torch.device`` with axis names.  One process drives every entry of a
mesh (single-controller, as in JAX).  An entry may repeat a device: such
entries are virtual ranks, which let one card, or the CPU in the tests,
run a four-rank mesh through the same code as four cards would.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh"]


class Mesh:
    """An n-dimensional array of devices with one name per axis.

    ``devices``: a (nested) list or an object ndarray of ``torch.device``
    (or device strings) with one dimension per name in ``axis_names``.
    ``shape`` is a dict of axis sizes, ``size`` the number of entries.
    A mesh mixing CPU and CUDA entries raises ValueError."""

    def __init__(self, devices, axis_names):
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {src.shape} needs that many "
                             f"distinct axis names, not {names}")
        if src.size == 0:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        kinds = {d.type for d in arr.flat}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh takes CPU or CUDA devices, not a mix: "
                             f"{sorted(kinds)}")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def sub(self, axes):
        """The devices along ``axes`` (in that order) at index 0 of every
        other axis: the entries that compute, where the others replicate."""
        axes = tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        index = tuple(slice(None) if n in axes else 0
                      for n in self.axis_names)
        kept = [n for n in self.axis_names if n in axes]
        return np.transpose(self.devices[index],
                            [kept.index(a) for a in axes])

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"
