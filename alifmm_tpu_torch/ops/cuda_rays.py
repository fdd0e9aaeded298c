"""K2 and K3, the ray kernels on the GPU: march, relaxation wave, ray times.

``csrc/rays.cu`` holds the three kernels (and ``segments``, which runs the
segment integrators they share on a list of segments, for checking).  They
replace loops that the JAX package leaves to XLA (``alifmm_tpu/rays.py``:
the march's ``while_loop``, ``relax_rays``' wave scan, ``ray_times``).  The
source is compiled with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``).

``march``, ``relax_wave`` and ``ray_times`` are the wrappers: for CUDA
tensors each launches its kernel on the current stream and raises on any
failure; for CPU tensors each runs its plain twin in ``rays.py``.
``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import grid as gridlib
from .. import rays as rayslib
from . import _build

__all__ = ["LAUNCHES", "build", "march", "relax_wave", "ray_times",
           "segments"]

LAUNCHES = {"march": 0, "relax_wave": 0, "ray_times": 0, "segments": 0}

SOURCE = os.path.join(_build.CSRC, "rays.cu")
_LIB = None
BUILD_LOG = ""
# the integrators' codes in csrc/rays.cu
SIMPSON3, SIMPSON5, WALK, EXACT = 0, 1, 2, 3

_PTR, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
_MAT = [_PTR, _PTR, _I32, _I32, _I32, _PTR, _I32]
_ARGTYPES = {
    "alifmm_march": _MAT + [_PTR, _I64, _I32, _I32] + [_PTR] * 8
    + [_I32] * 7 + [_F64] * 6 + [_I32, _PTR],
    "alifmm_relax_wave": _MAT + [_PTR] * 5 + [_I32, _I32, _I32, _F64, _I32,
                                              _I32, _PTR],
    "alifmm_ray_times": _MAT + [_PTR] * 4 + [_I32, _I32, _I32, _PTR],
    "alifmm_segments": _MAT + [_I32] + [_PTR] * 5 + [_I64, _I32, _PTR],
}


def build(verbose: bool = False):
    """Compile ``csrc/rays.cu`` (once per process and source version) and
    return the loaded library.  ``verbose`` adds ``-Xptxas -v`` and keeps
    its report in ``BUILD_LOG``."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = _build.compile_library(SOURCE, "alifmm_rays", verbose)
    for stem, argtypes in _ARGTYPES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = argtypes
            fn.restype = _I32
    _LIB = lib
    return lib


def _fn(stem, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the ray kernels take float32 or float64, not "
                        f"{dtype}")
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    return getattr(build(), stem + suffix)


def _check(name, t, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the model on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


def _mat_args(model: gridlib.Model, mat_flat, subgrid_size):
    """The leading arguments every kernel takes: material rows, curve
    table, grid and spacing (``dnx`` goes by pointer: reading it here
    would make the host wait for the device).  Returns (args, the tensors
    behind the pointers).  The caller keeps the tensors in a local until it
    has launched: ``contiguous()`` may have made a copy, and a freed copy's
    memory could go to the outputs the caller allocates before the
    launch."""
    Z, X = model.shape
    dt, dev = model.dtype, model.device
    mat_flat = _check("mat_flat", mat_flat, dt, dev, (Z * X, 3))
    curves = _check("ray_curves", model.ray_curves, dt, dev)
    dnx = _check("dnx", model.dnx, dt, dev, ())
    if int(subgrid_size) != subgrid_size or subgrid_size < 1:
        raise ValueError(f"subgrid_size {subgrid_size!r} is not a positive "
                         f"integer")
    args = [mat_flat.data_ptr(), curves.data_ptr(), curves.shape[1], Z, X,
            dnx.data_ptr(), int(subgrid_size)]
    return args, (mat_flat, curves, dnx)


def _launch(name, fn, args, device):
    """Launch on the current stream and count the launch."""
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _quad_scorer(quad):
    return EXACT if not quad else SIMPSON3 if quad == 3 else SIMPSON5


def march(model: gridlib.Model, mat_flat, rec_ttf, ttf_index, source_xy,
          receiver_xy, spec):
    """March every ray from source to end (``rays.march_plain`` states the
    result): K2 in one launch on CUDA tensors, the plain twin on CPU
    tensors.  ``spec``: a ``rays.MarchSpec``.  ``ttf_index`` must lie within
    the field stack: ``trace_rays`` checks that, the kernel does not."""
    if not rec_ttf.is_cuda:
        return rayslib.march_plain(model, mat_flat, rec_ttf, ttf_index,
                                   source_xy, receiver_xy, spec)
    dt, dev = model.dtype, model.device
    R = source_xy.shape[0]
    if rec_ttf.dim() not in (2, 3):
        raise ValueError(f"fields of shape {tuple(rec_ttf.shape)}")
    rec_ttf = _check("rec_ttf", rec_ttf, dt, dev)
    TZ, TX = rec_ttf.shape[-2:]
    if TZ < 2 or TX < 2:
        raise ValueError("fields need at least 2 x 2 points")
    ttf_index = _check("ttf_index", ttf_index, torch.int64, dev, (R,))
    src = _check("source_xy", source_xy.to(dt), dt, dev, (R, 2))
    rec = _check("receiver_xy", receiver_xy.to(dt), dt, dev, (R, 2))
    if spec.K < 3 or spec.max_steps < 0:
        raise ValueError(f"march with K={spec.K}, max_steps={spec.max_steps}")
    mat, _held = _mat_args(model, mat_flat, spec.s)
    P = spec.max_steps + 2
    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    length = torch.empty(R, dtype=torch.int64, device=dev)
    reason = torch.empty(R, dtype=torch.int64, device=dev)
    steps = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return bx, by, length, reason, steps
    s = spec.s
    args = mat + [
        rec_ttf.data_ptr(), TZ * TX if rec_ttf.dim() == 3 else 0, TZ, TX,
        ttf_index.data_ptr(), src.data_ptr(), rec.data_ptr(), bx.data_ptr(),
        by.data_ptr(), length.data_ptr(), reason.data_ptr(),
        steps.data_ptr(), R, P, spec.max_steps, spec.K, spec.k_step,
        spec.in_cross, spec.plane_dist, float(spec.k_step * s),
        float(spec.near_step * s), float(spec.stride), (4.0 * s) ** 2,
        ((spec.k_step + 3.0) * s) ** 2, (1.6 * s) ** 2, spec.scorer]
    _launch("march", _fn("alifmm_march", dt), args, dev)
    return bx, by, length, reason, steps


def relax_wave(model: gridlib.Model, mat_flat, xs, ys, lengths, subgrid_size,
               parity: int, h: float, max_cross: int = 12,
               quad: bool | int = False):
    """One relaxation wave over (R, P) polylines
    (``rays.relax_wave_plain`` states the result): K3's relax-wave kernel
    on CUDA tensors, the plain twin on CPU tensors."""
    if not xs.is_cuda:
        return rayslib.relax_wave_plain(model, mat_flat, xs, ys, lengths,
                                        subgrid_size, parity, h, max_cross,
                                        quad)
    dt, dev = model.dtype, model.device
    R, P = xs.shape
    xs = _check("ray_x", xs, dt, dev)
    ys = _check("ray_y", ys, dt, dev, (R, P))
    lengths = _check("lengths", lengths, torch.int64, dev, (R,))
    mat, _held = _mat_args(model, mat_flat, subgrid_size)
    ox = torch.empty_like(xs)
    oy = torch.empty_like(ys)
    if R * P == 0:
        return ox, oy
    args = mat + [xs.data_ptr(), ys.data_ptr(), lengths.data_ptr(),
                  ox.data_ptr(), oy.data_ptr(), R, P, int(parity), float(h),
                  int(max_cross), _quad_scorer(quad)]
    _launch("relax_wave", _fn("alifmm_relax_wave", dt), args, dev)
    return ox, oy


def ray_times(model: gridlib.Model, mat_flat, ray_x, ray_y, lengths,
              subgrid_size, max_cross: int = 16):
    """Travel times of (R, P) polylines (``rays.ray_times_plain`` states
    the result): K3's ray-times kernel on CUDA tensors, the plain twin on
    CPU tensors."""
    if not ray_x.is_cuda:
        return rayslib.ray_times_plain(model, mat_flat, ray_x, ray_y,
                                       lengths, subgrid_size, max_cross)
    dt, dev = model.dtype, model.device
    R, P = ray_x.shape
    ray_x = _check("ray_x", ray_x, dt, dev)
    ray_y = _check("ray_y", ray_y, dt, dev, (R, P))
    lengths = _check("lengths", lengths, torch.int64, dev, (R,))
    mat, _held = _mat_args(model, mat_flat, subgrid_size)
    out = torch.zeros(R, dtype=dt, device=dev)
    if R == 0:
        return out
    args = mat + [ray_x.data_ptr(), ray_y.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(), R, P, int(max_cross)]
    _launch("ray_times", _fn("alifmm_ray_times", dt), args, dev)
    return out


def segments(model: gridlib.Model, mat_flat, kind: int, x1, y1, x2, y2,
             subgrid_size, cross: int = 16):
    """The kernels' segment integrator ``kind`` (SIMPSON3, SIMPSON5, WALK,
    EXACT) on (n,) CUDA segments: what ``segment_time_quad3``,
    ``segment_time_quad``, ``_segment_time_walk`` and ``segment_time`` of
    ``rays.py`` compute.  For checking the device functions; no entry
    point calls it."""
    dt, dev = model.dtype, model.device
    if not x1.is_cuda:
        raise ValueError("segments runs the CUDA integrators and takes CUDA "
                         "tensors")
    n = x1.shape[0]
    pts = [_check(nm, t, dt, dev, (n,)) for nm, t in
           (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2))]
    mat, _held = _mat_args(model, mat_flat, subgrid_size)
    out = torch.empty(n, dtype=dt, device=dev)
    if n == 0:
        return out
    args = mat + [int(kind)] + [p.data_ptr() for p in pts] + [
        out.data_ptr(), n, int(cross)]
    _launch("segments", _fn("alifmm_segments", dt), args, dev)
    return out
