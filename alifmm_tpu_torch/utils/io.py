"""Saving and loading fields and ray results.

Counterpart of the first half of ``alifmm_tpu/utils/io.py``: a bundled
field checkpoint (``save_fields``/``load_fields``, so that a long job over
a transducer array can resume) and the weld example's four ray files
(``save_rays``/``load_rays``), with the same file names and keys.  Tensors
are copied to the host first; what is loaded is numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_fields", "load_fields", "save_rays", "load_rays"]


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def save_fields(path, fields, source_indices=None):
    """Save a (n_src, Z, X) field stack as a compressed ``.npz``, with the
    sources it belongs to (``source_indices``, by default 0..n_src-1)."""
    fields = _host(fields)
    np.savez_compressed(
        path, fields=fields,
        source_indices=(_host(source_indices) if source_indices is not None
                        else np.arange(fields.shape[0])))


def load_fields(path):
    """(fields, source_indices) from ``save_fields``' file."""
    d = np.load(path)
    return d["fields"], d["source_indices"]


def save_rays(out_dir, times, ray_paths_x, ray_paths_y, ray_len):
    """The weld example's outputs in ``out_dir``: trav_times.npy,
    ray_paths_x.npy and ray_paths_y.npy (cut to the longest ray) and
    ray_len.npy."""
    os.makedirs(out_dir, exist_ok=True)
    ray_len = _host(ray_len)
    max_len = int(np.max(ray_len)) if np.max(ray_len) > 0 else 1
    np.save(os.path.join(out_dir, "trav_times.npy"), _host(times))
    np.save(os.path.join(out_dir, "ray_paths_x.npy"),
            _host(ray_paths_x)[:, :, :max_len])
    np.save(os.path.join(out_dir, "ray_paths_y.npy"),
            _host(ray_paths_y)[:, :, :max_len])
    np.save(os.path.join(out_dir, "ray_len.npy"), ray_len)


def load_rays(in_dir):
    """(times, ray_paths_x, ray_paths_y, ray_len) from ``save_rays``."""
    return tuple(np.load(os.path.join(in_dir, f"{name}.npy")) for name in
                 ("trav_times", "ray_paths_x", "ray_paths_y", "ray_len"))
