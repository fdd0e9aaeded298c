"""K6, the model build's fallback slowness planes on the GPU.

``csrc/planes.cu`` computes what ``grid._np_fallback_slowness_planes``
computes on the host -- the group slowness of every point at the FD
fallback's four fixed wave angles -- in one launch, a thread a point, in
float64 registers, and writes the planes in the fields' dtype.  It is its
own small library (``ops/_build.py``: ``nvcc`` for ``sm_90a`` at first
use, loaded with ``ctypes``), so that it builds in seconds and leaves the
other kernels' builds as they are.

``fallback_planes`` is the wrapper, for CUDA tensors only: a CPU build
keeps the numpy function (``grid.make_model``), which is also the twin the
kernel is held to.  It checks its inputs before anything is built or
launched, allocates the output, launches on the current stream and reads
nothing back to the host.  ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _build

__all__ = ["LAUNCHES", "build", "fallback_planes"]

LAUNCHES = 0

SOURCE = os.path.join(_build.CSRC, "planes.cu")
_LIB = None
BUILD_LOG = ""
# rows of the group table the interpolation reads (angles 0..179)
TABLE_ROWS = 180


def build(verbose: bool = False):
    """Compile ``csrc/planes.cu`` (once per process and source version) and
    return the loaded library.  ``verbose`` adds ``-Xptxas -v`` and keeps
    its report in ``BUILD_LOG``."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = _build.compile_library(SOURCE, "alifmm_planes", verbose)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("alifmm_fallback_planes_f32", "alifmm_fallback_planes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32, i32, i64, ptr, ptr]
        fn.restype = i32
    _LIB = lib
    return lib


def _check(veln, velpn, vel_map, stif, group_tab, out):
    """Raise on what K6 does not take: a float type other than float32 or
    float64 (or one that differs between the float inputs), ``velpn`` not
    int32, shapes that do not fit, a tensor that is not contiguous, or
    tensors off one CUDA device."""
    named = (("veln", veln), ("velpn", velpn), ("vel_map", vel_map),
             ("stif", stif), ("group_tab", group_tab))
    if out is not None:
        named += (("out", out),)
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"K6 takes tensors; {name} is {type(t).__name__}")
    dt = veln.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K6 takes float32 or float64 fields, not {dt}")
    for name, t in named:
        want = torch.int32 if name == "velpn" else dt
        if t.dtype != want:
            raise TypeError(f"K6 takes {name} in {want}, not {t.dtype}")
    shape = tuple(veln.shape)
    if len(shape) != 2:
        raise ValueError(f"K6 takes (Z, X) fields, not {shape}")
    wants = [("velpn", velpn, shape), ("vel_map", vel_map, shape),
             ("stif", stif, shape + (5,))]
    if out is not None:
        wants.append(("out", out, (4,) + shape))
    for name, t, want in wants:
        if tuple(t.shape) != want:
            raise ValueError(f"K6 takes {name} of shape {want}, not "
                             f"{tuple(t.shape)}")
    if group_tab.dim() != 2 or group_tab.shape[0] < TABLE_ROWS:
        raise ValueError(f"K6 takes a (rows >= {TABLE_ROWS}, M) group table, "
                         f"not {tuple(group_tab.shape)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"K6 takes contiguous tensors; {name} is not")
        if t.device.type != "cuda":
            raise ValueError(f"K6 is a CUDA kernel; {name} is on {t.device} "
                             f"(a CPU build takes "
                             f"grid._np_fallback_slowness_planes)")
        if t.device != veln.device:
            raise ValueError(f"{name} is on {t.device}, veln on "
                             f"{veln.device}")


def fallback_planes(veln, velpn, vel_map, stif, group_tab, has_stif,
                    out=None):
    """The four fallback slowness planes of (Z, X) CUDA fields (``stif``
    (Z, X, 5), ``group_tab`` (R, M)) as (4, Z, X) in the fields' dtype:
    ``grid._np_fallback_slowness_planes`` computed in float64 and rounded
    once.  ``has_stif``: stiffness points (``velpn == 0``) take the
    Christoffel solve, as in ``make_model``.  ``out``: a (4, Z, X) tensor
    to write into instead of a new one (for timing launches alone)."""
    global LAUNCHES
    _check(veln, velpn, vel_map, stif, group_tab, out)
    if out is None:
        out = torch.empty((4, *veln.shape), dtype=veln.dtype,
                          device=veln.device)
    lib = build()
    fn = (lib.alifmm_fallback_planes_f32 if veln.dtype == torch.float32
          else lib.alifmm_fallback_planes_f64)
    with torch.cuda.device(veln.device):
        stream = torch.cuda.current_stream(veln.device).cuda_stream
        err = fn(veln.data_ptr(), velpn.data_ptr(), vel_map.data_ptr(),
                 stif.data_ptr(), group_tab.data_ptr(), group_tab.shape[1],
                 int(bool(has_stif)), veln.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K6 (fallback planes) launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
