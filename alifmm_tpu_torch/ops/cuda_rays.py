"""K2 and K3, the ray kernels on the GPU: the march, and the relaxation
with the ray times.

``csrc/rays.cu`` holds the two kernels (and ``segments``, which runs the
segment integrators they share on a list of segments, for checking).  They
replace loops that the JAX package leaves to XLA (``alifmm_tpu/rays.py``:
the march's ``while_loop``, ``relax_rays``' wave scan, ``ray_times``).  The
source is compiled with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``).

``march`` and ``relax_and_times`` are the wrappers: for CUDA tensors each
launches its kernel on the current stream and raises on any failure; for
CPU tensors each runs its plain twin in ``rays.py``.  ``relax_wave`` and
``ray_times`` are ``relax_and_times`` with one wave and no times, and with
no waves.  ``LAUNCHES`` counts kernel launches by kernel name.

Both kernels copy the model's curve table into shared memory where it
fits, and K3 a ray's polyline; ``shared=False`` on ``prepare_march`` and
``prepare_relax_and_times`` keeps both in device memory, so that a check
can hold that path against the twins too.
"""

from __future__ import annotations

import ctypes
import os
import typing

import torch

from .. import grid as gridlib
from .. import rays as rayslib
from . import _build

__all__ = ["LAUNCHES", "build", "march", "relax_and_times", "relax_wave",
           "ray_times", "segments", "prepare_march", "prepare_relax_and_times",
           "occupancy"]

LAUNCHES = {"march": 0, "relax_times": 0, "segments": 0}

SOURCE = os.path.join(_build.CSRC, "rays.cu")
_LIB = None
BUILD_LOG = ""
# the integrators' codes in csrc/rays.cu
SIMPSON3, SIMPSON5, WALK, EXACT = 0, 1, 2, 3
# dynamic shared memory a block may use on sm_90 after the opt-in (kMaxSmem
# in csrc/rays.cu); the march keeps its blocks to a quarter of it, so that
# four of them (16 warps) share an SM
MAX_SMEM = 232448
MARCH_SMEM = MAX_SMEM // 4

_PTR, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
_MAT = [_PTR, _PTR, _I32, _I32, _I32, _PTR, _I32]
_ARGTYPES = {
    "alifmm_march": _MAT + [_PTR, _I64, _I32, _I32] + [_PTR] * 8
    + [_I32] * 7 + [_F64] * 6 + [_I32] * 3 + [_PTR, _PTR],
    "alifmm_relax_times": _MAT + [_PTR] * 6 + [_I32] * 4 + [_F64]
    + [_I32] * 5 + [_PTR],
    "alifmm_segments": _MAT + [_I32] + [_PTR] * 5 + [_I64, _I32, _PTR],
    "alifmm_occupancy": [_I32, _I32, _I32, _I64],
}
_SIZES = {"alifmm_march_smem": [_I32] * 6,
          "alifmm_relax_times_smem": [_I32] * 5}


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
    for name, argtypes in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I64
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
    behind the pointers).  The caller keeps the tensors until it has
    launched: ``contiguous()`` may have made a copy, and a freed copy's
    memory could go to the outputs the caller allocates before the
    launch."""
    Z, X = model.shape
    dt, dev = model.dtype, model.device
    mat_flat = _check("mat_flat", mat_flat, dt, dev, (Z * X, 4))
    if mat_flat.data_ptr() % 16:
        raise ValueError("mat_flat rows must be 16-byte aligned")
    curves = _check("ray_curves", model.ray_curves, dt, dev)
    dnx = _check("dnx", model.dnx, dt, dev, ())
    if int(subgrid_size) != subgrid_size or subgrid_size < 1:
        raise ValueError(f"subgrid_size {subgrid_size!r} is not a positive "
                         f"integer")
    args = [mat_flat.data_ptr(), curves.data_ptr(), curves.shape[1], Z, X,
            dnx.data_ptr(), int(subgrid_size)]
    return args, (mat_flat, curves, dnx)


class Prepared(typing.NamedTuple):
    """One kernel launch with its arguments bound and its outputs
    allocated.  ``run()`` launches it on the current stream and counts
    nothing (``_launch`` counts); ``plan`` says where its tables live."""

    name: str
    fn: typing.Any
    args: list
    out: tuple
    held: tuple
    device: torch.device
    plan: dict

    def run(self):
        err = self.fn(*self.args,
                      torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")


def _launch(p: Prepared):
    """Launch and count the launch."""
    p.run()
    LAUNCHES[p.name] += 1


def _quad_scorer(quad):
    return EXACT if not quad else SIMPSON3 if quad == 3 else SIMPSON5


def march_lanes(spec) -> int:
    """Lanes per ray: 64 (two warps) when a step has more than 32
    independent pieces of work (candidates for the walk; for Simpson N the
    candidates' N samples and their field samples), else 32."""
    work = spec.K * {SIMPSON3: 4, SIMPSON5: 6}.get(spec.scorer, 1)
    return 64 if work > 32 else 32


def prepare_march(model: gridlib.Model, mat_flat, rec_ttf, ttf_index,
                  source_xy, receiver_xy, spec, shared: bool = True,
                  profile: bool = False) -> Prepared:
    """K2's launch on CUDA tensors (see ``march``).  ``profile`` launches
    the float32 build that adds clock64 cycles by part of the step into an
    (R, 3) int64 output: scoring, reduction, the rest."""
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
    if profile and dt != torch.float32:
        raise TypeError("the march's profiling build is float32 only")
    mat, held = _mat_args(model, mat_flat, spec.s)
    lanes = march_lanes(spec)
    item = rec_ttf.element_size()
    sizes = build()
    smem = sizes.alifmm_march_smem(spec.scorer, spec.K, lanes, 1, mat[2],
                                   item)
    curves_smem = bool(shared) and smem <= MARCH_SMEM
    if not curves_smem:
        smem = sizes.alifmm_march_smem(spec.scorer, spec.K, lanes, 0, mat[2],
                                       item)
    P = spec.max_steps + 2
    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    length = torch.empty(R, dtype=torch.int64, device=dev)
    reason = torch.empty(R, dtype=torch.int64, device=dev)
    steps = torch.empty(R, dtype=torch.int64, device=dev)
    prof = (torch.zeros((R, 3), dtype=torch.int64, device=dev) if profile
            else None)
    s = spec.s
    args = mat + [
        rec_ttf.data_ptr(), TZ * TX if rec_ttf.dim() == 3 else 0, TZ, TX,
        ttf_index.data_ptr(), src.data_ptr(), rec.data_ptr(), bx.data_ptr(),
        by.data_ptr(), length.data_ptr(), reason.data_ptr(),
        steps.data_ptr(), R, P, spec.max_steps, spec.K, spec.k_step,
        spec.in_cross, spec.plane_dist, float(spec.k_step * s),
        float(spec.near_step * s), float(spec.stride), (4.0 * s) ** 2,
        ((spec.k_step + 3.0) * s) ** 2, (1.6 * s) ** 2, spec.scorer, lanes,
        int(curves_smem), None if prof is None else prof.data_ptr()]
    out = (bx, by, length, reason, steps) + ((prof,) if profile else ())
    return Prepared("march", _fn("alifmm_march", dt), args, out,
                    held + (rec_ttf, ttf_index, src, rec), dev,
                    dict(lanes=lanes, curves_smem=curves_smem, smem=smem))


def march(model: gridlib.Model, mat_flat, rec_ttf, ttf_index, source_xy,
          receiver_xy, spec):
    """March every ray from source to end (``rays.march_plain`` states the
    result): K2 in one launch on CUDA tensors, the plain twin on CPU
    tensors.  ``spec``: a ``rays.MarchSpec``.  ``ttf_index`` must lie within
    the field stack: ``trace_rays`` checks that, the kernel does not."""
    if not rec_ttf.is_cuda:
        return rayslib.march_plain(model, mat_flat, rec_ttf, ttf_index,
                                   source_xy, receiver_xy, spec)
    p = prepare_march(model, mat_flat, rec_ttf, ttf_index, source_xy,
                      receiver_xy, spec)
    if source_xy.shape[0]:
        _launch(p)
    return p.out


def prepare_relax_and_times(model: gridlib.Model, mat_flat, xs, ys, lengths,
                            subgrid_size, waves: int = 0,
                            first_parity: int = 1, h: float | None = None,
                            relax_cross: int = 12, quad: bool | int = False,
                            times_cross: int = 16, times: bool = True,
                            shared: bool = True) -> Prepared:
    """K3's launch on CUDA tensors (see ``relax_and_times``)."""
    dt, dev = model.dtype, model.device
    R, P = xs.shape
    xs = _check("ray_x", xs, dt, dev)
    ys = _check("ray_y", ys, dt, dev, (R, P))
    lengths = _check("lengths", lengths, torch.int64, dev, (R,))
    if waves < 0 or not (waves or times):
        raise ValueError(f"relax_and_times with {waves} waves and "
                         f"times={times}")
    mat, held = _mat_args(model, mat_flat, subgrid_size)
    h = float(subgrid_size) if h is None else float(h)
    item = xs.element_size()
    sizes = build().alifmm_relax_times_smem
    curves_smem = bool(shared) and sizes(P, 1, 0, mat[2], item) <= MAX_SMEM
    poly_smem = (bool(shared) and waves > 0
                 and sizes(P, int(curves_smem), 1, mat[2], item) <= MAX_SMEM)
    smem = sizes(P, int(curves_smem), int(poly_smem), mat[2], item)
    if waves:
        ox, oy = torch.empty_like(xs), torch.empty_like(ys)
    else:
        ox, oy = xs, ys
    out_t = torch.zeros(R, dtype=dt, device=dev) if times else None
    args = mat + [
        xs.data_ptr(), ys.data_ptr(), lengths.data_ptr(),
        ox.data_ptr() if waves else None, oy.data_ptr() if waves else None,
        None if out_t is None else out_t.data_ptr(), R, P, int(waves),
        int(first_parity) % 2, h, int(relax_cross), _quad_scorer(quad),
        int(times_cross), int(curves_smem), int(poly_smem)]
    return Prepared("relax_times", _fn("alifmm_relax_times", dt), args,
                    (ox, oy, out_t), held + (xs, ys, lengths), dev,
                    dict(curves_smem=curves_smem, poly_smem=poly_smem,
                         smem=smem))


def relax_and_times(model: gridlib.Model, mat_flat, xs, ys, lengths,
                    subgrid_size, waves: int = 0, first_parity: int = 1,
                    h: float | None = None, relax_cross: int = 12,
                    quad: bool | int = False, times_cross: int = 16,
                    times: bool = True):
    """``waves`` relaxation waves of alternating parity, the first of
    ``first_parity``, over (R, P) polylines, then (with ``times``) the
    travel times of the result; ``rays.relax_and_times_plain`` states the
    result.  K3 in one launch on CUDA tensors, the plain twin on CPU
    tensors.  Returns (xs, ys, times or None): the inputs themselves when
    there are no waves."""
    if not xs.is_cuda:
        return rayslib.relax_and_times_plain(
            model, mat_flat, xs, ys, lengths, subgrid_size, waves,
            first_parity, h, relax_cross, quad, times_cross, times)
    p = prepare_relax_and_times(model, mat_flat, xs, ys, lengths,
                                subgrid_size, waves, first_parity, h,
                                relax_cross, quad, times_cross, times)
    if xs.shape[0] * xs.shape[1]:
        _launch(p)
    return p.out


def relax_wave(model: gridlib.Model, mat_flat, xs, ys, lengths, subgrid_size,
               parity: int, h: float, max_cross: int = 12,
               quad: bool | int = False):
    """One relaxation wave over (R, P) polylines
    (``rays.relax_wave_plain`` states the result): K3 with one wave and no
    times on CUDA tensors, the plain twin on CPU tensors."""
    if not xs.is_cuda:
        return rayslib.relax_wave_plain(model, mat_flat, xs, ys, lengths,
                                        subgrid_size, parity, h, max_cross,
                                        quad)
    ox, oy, _ = relax_and_times(model, mat_flat, xs, ys, lengths,
                                subgrid_size, 1, parity, h, max_cross, quad,
                                times=False)
    return ox, oy


def ray_times(model: gridlib.Model, mat_flat, ray_x, ray_y, lengths,
              subgrid_size, max_cross: int = 16):
    """Travel times of (R, P) polylines (``rays.ray_times_plain`` states
    the result): K3 with no waves on CUDA tensors, the plain twin on CPU
    tensors."""
    if not ray_x.is_cuda:
        return rayslib.ray_times_plain(model, mat_flat, ray_x, ray_y,
                                       lengths, subgrid_size, max_cross)
    return relax_and_times(model, mat_flat, ray_x, ray_y, lengths,
                           subgrid_size, times_cross=max_cross)[2]


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
    mat, held = _mat_args(model, mat_flat, subgrid_size)
    out = torch.empty(n, dtype=dt, device=dev)
    args = mat + [int(kind)] + [p.data_ptr() for p in pts] + [
        out.data_ptr(), n, int(cross)]
    p = Prepared("segments", _fn("alifmm_segments", dt), args, (out,),
                 held + tuple(pts), dev, {})
    if n:
        _launch(p)
    return out


def occupancy(p: Prepared, scorer: int, dtype) -> int:
    """Blocks of ``p``'s kernel resident per SM at its shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); 128 threads a
    block."""
    which = 0 if p.name == "march" else 1
    profile = p.name == "march" and p.args[-1] is not None
    blocks = _fn("alifmm_occupancy", dtype)(which, scorer, int(profile),
                                            p.plan["smem"])
    if blocks < 0:
        raise RuntimeError(f"no occupancy for {p.name}")
    return blocks
