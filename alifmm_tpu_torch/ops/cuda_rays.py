"""K2, K3 and K4, the ray kernels on the GPU: the plane-search march, the
relaxation with the ray times, and the descent march.

``csrc/rays.cu`` holds K2 and K3 (and ``segments``, which runs the segment
integrators they share on a list of segments, for checking);
``csrc/descent.cu`` holds K4, which shares their device functions through
``csrc/ray_device.cuh``.  They replace loops that the JAX package leaves
to XLA (``alifmm_tpu/rays.py``: the marches' ``while_loop``s,
``relax_rays``' wave scan, ``ray_times``).  Each source is compiled with
``nvcc`` at first use, apart from the other, and bound with ``ctypes``
(``ops/_build.py``).

``march``, ``march_descent`` and ``relax_and_times`` are the wrappers: for
CUDA tensors each launches its kernel on the current stream and raises on
any failure; for CPU tensors each runs its plain twin in ``rays.py``.
``relax_wave`` and ``ray_times`` are ``relax_and_times`` with one wave and
no times, and with no waves.  ``LAUNCHES`` counts kernel launches by
kernel name.

K2 and K3 copy the model's curve table into shared memory where it
fits, and K3 a ray's polyline; ``shared=False`` on ``prepare_march`` and
``prepare_relax_and_times`` keeps both in device memory, so that a check
can hold that path against the twins too.

The material rows (``rays._material_flat``) pick the material path: 4
columns read the unified curve table, 8 columns (``exact_materials``) the
group table or the Christoffel solve per sample.  ``MarchSpec.grid``
picks K2's nearest-point field tap over the bilinear one, and a march
with ``MarchSpec.k_fast`` reads the uniform mask ``fast``.  Each choice
is a separate instantiation of the kernel in ``csrc/rays.cu``.  K4 reads
the 4-column rows, a warp a ray, with the skew table (and for its scored
window, ``DescentSpec.score_k`` > 0, the curve table) in shared memory
where it fits; ``shared=False`` on ``prepare_march_descent`` keeps them in
device memory.
"""

from __future__ import annotations

import ctypes
import os
import typing

import torch

from .. import grid as gridlib
from .. import rays as rayslib
from . import _build

__all__ = ["LAUNCHES", "build", "build_descent", "march", "march_descent",
           "relax_and_times", "relax_wave", "ray_times", "segments",
           "prepare_march", "prepare_march_descent",
           "prepare_relax_and_times", "occupancy"]

LAUNCHES = {"march": 0, "relax_times": 0, "segments": 0, "descent": 0}

SOURCE = os.path.join(_build.CSRC, "rays.cu")
DESCENT_SOURCE = os.path.join(_build.CSRC, "descent.cu")
_LIB = None
_DESCENT_LIB = None
BUILD_LOG = ""
DESCENT_BUILD_LOG = ""
# the descent's scored window: odd, a lane a candidate (kMaxWindow)
MAX_WINDOW = 31
# the integrators' codes in csrc/rays.cu
SIMPSON3, SIMPSON5, WALK, EXACT = 0, 1, 2, 3
# material paths and field taps (MatKind, TapKind in csrc/rays.cu)
MAT_CURVES, MAT_STIFFNESS = 0, 1
TAP_BILINEAR, TAP_NEAREST = 0, 1
# dynamic shared memory a block may use on sm_90 after the opt-in (kMaxSmem
# in csrc/rays.cu); the march keeps its blocks to a quarter of it, so that
# four of them (16 warps) share an SM
MAX_SMEM = 232448
MARCH_SMEM = MAX_SMEM // 4

_PTR, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
_MAT = [_PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _I32, _I32]
_ARGTYPES = {
    "alifmm_march": _MAT + [_PTR, _I64, _I32, _I32] + [_PTR] * 8
    + [_I32] * 7 + [_F64] * 6 + [_I32] * 3 + [_PTR, _I32, _PTR, _F64, _F64,
                                              _PTR],
    "alifmm_relax_times": _MAT + [_PTR] * 6 + [_I32] * 4 + [_F64]
    + [_I32] * 5 + [_PTR],
    "alifmm_segments": _MAT + [_I32] + [_PTR] * 5 + [_I64, _I32, _PTR],
    "alifmm_occupancy": [_I32] * 5 + [_I64],
}
_SIZES = {"alifmm_march_smem": [_I32] * 6,
          "alifmm_relax_times_smem": [_I32] * 5}
_DESCENT_ARGTYPES = ([_PTR, _PTR, _I32, _I32, _I32, _PTR, _I32, _PTR, _PTR,
                      _I64, _I32, _I32] + [_PTR] * 8 + [_I32] * 6
                     + [_F64] * 8 + [_I32, _I32, _PTR, _PTR])
# columns of K4's profile output (kProfCols in csrc/descent.cu)
DESCENT_PARTS = ("tap", "row", "rest", "score", "reduce")
DESCENT_PROFILE = DESCENT_PARTS + ("exact_steps", "window_pieces",
                                   "exact_pieces")


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


def build_descent(verbose: bool = False):
    """Compile ``csrc/descent.cu`` (once per process and version of it and
    its header) and return the loaded library; ``verbose`` as ``build``,
    its report in ``DESCENT_BUILD_LOG``."""
    global _DESCENT_LIB, DESCENT_BUILD_LOG
    if _DESCENT_LIB is not None:
        return _DESCENT_LIB
    lib, DESCENT_BUILD_LOG = _build.compile_library(
        DESCENT_SOURCE, "alifmm_descent", verbose)
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, "alifmm_descent" + suffix)
        fn.argtypes = _DESCENT_ARGTYPES
        fn.restype = _I32
        fn = getattr(lib, "alifmm_descent_occupancy" + suffix)
        fn.argtypes = [_I32, _I32, _I64]
        fn.restype = _I32
    lib.alifmm_descent_smem.argtypes = [_I32] * 4
    lib.alifmm_descent_smem.restype = _I64
    _DESCENT_LIB = lib
    return lib


def _fn(stem, dtype, lib=build):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the ray kernels take float32 or float64, not "
                        f"{dtype}")
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    return getattr(lib(), stem + suffix)


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
    """The leading arguments every kernel takes: material rows, velocity
    table (the unified curves for 4-column rows, the group table for
    8-column ones), grid and spacing (``dnx`` goes by pointer: reading it
    here would make the host wait for the device), the material path and
    whether the model has stiffness.  Returns (args, the tensors behind
    the pointers).  The caller keeps the tensors until it has launched:
    ``contiguous()`` may have made a copy, and a freed copy's memory could
    go to the outputs the caller allocates before the launch."""
    Z, X = model.shape
    dt, dev = model.dtype, model.device
    ncol = mat_flat.shape[-1] if mat_flat.dim() == 2 else 0
    if ncol not in (4, 8):
        raise ValueError(f"mat_flat of shape {tuple(mat_flat.shape)}: rows "
                         f"of 4 or 8 columns")
    mat_flat = _check("mat_flat", mat_flat, dt, dev, (Z * X, ncol))
    if mat_flat.data_ptr() % 16:
        raise ValueError("mat_flat rows must be 16-byte aligned")
    kind = MAT_CURVES if ncol == 4 else MAT_STIFFNESS
    table = model.ray_curves if kind == MAT_CURVES else model.group_tab
    curves = _check("velocity table", table, dt, dev)
    dnx = _check("dnx", model.dnx, dt, dev, ())
    if int(subgrid_size) != subgrid_size or subgrid_size < 1:
        raise ValueError(f"subgrid_size {subgrid_size!r} is not a positive "
                         f"integer")
    args = [mat_flat.data_ptr(), curves.data_ptr(), curves.shape[1], Z, X,
            dnx.data_ptr(), int(subgrid_size), kind, int(model.has_stif)]
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
                  source_xy, receiver_xy, spec, fast=None, shared: bool = True,
                  profile: bool = False) -> Prepared:
    """K2's launch on CUDA tensors (see ``march``).  ``profile`` launches
    the float32 build (unified curves, bilinear tap) that adds clock64
    cycles by part of the step into an (R, 3) int64 output: scoring,
    reduction, the rest."""
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
    mat, held = _mat_args(model, mat_flat, spec.s)
    tap = TAP_NEAREST if spec.grid else TAP_BILINEAR
    if profile and (dt != torch.float32 or mat[7] != MAT_CURVES
                    or tap != TAP_BILINEAR):
        raise TypeError("the march's profiling build is float32 with the "
                        "unified curves and the bilinear tap only")
    if spec.k_fast > 0:
        Z, X = model.shape
        if fast is None:
            raise ValueError("a march with fast_step_scale needs the "
                             "uniform mask")
        fast = _check("fast", fast.to(torch.uint8), torch.uint8, dev,
                      (Z * X,))
    else:
        fast = None
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
        int(curves_smem), None if prof is None else prof.data_ptr(), tap,
        None if fast is None else fast.data_ptr(), float(spec.k_fast * s),
        ((spec.k_fast + 3.0) * s) ** 2]
    out = (bx, by, length, reason, steps) + ((prof,) if profile else ())
    return Prepared("march", _fn("alifmm_march", dt), args, out,
                    held + (rec_ttf, ttf_index, src, rec, fast), dev,
                    dict(lanes=lanes, curves_smem=curves_smem, smem=smem,
                         mat_kind=mat[7], tap=tap))


def march(model: gridlib.Model, mat_flat, rec_ttf, ttf_index, source_xy,
          receiver_xy, spec, fast=None):
    """March every ray from source to end (``rays.march_plain`` states the
    result): K2 in one launch on CUDA tensors, the plain twin on CPU
    tensors.  ``spec``: a ``rays.MarchSpec``; ``fast``: the (Z*X,) uniform
    mask when ``spec.k_fast`` > 0.  ``ttf_index`` must lie within the
    field stack: ``trace_rays`` checks that, the kernel does not."""
    if not rec_ttf.is_cuda:
        return rayslib.march_plain(model, mat_flat, rec_ttf, ttf_index,
                                   source_xy, receiver_xy, spec, fast)
    p = prepare_march(model, mat_flat, rec_ttf, ttf_index, source_xy,
                      receiver_xy, spec, fast)
    if source_xy.shape[0]:
        _launch(p)
    return p.out


def prepare_march_descent(model: gridlib.Model, mat_flat, rec_ttf,
                          ttf_index, source_xy, receiver_xy, spec,
                          shared: bool = True, fast: bool = True,
                          profile: bool = False) -> Prepared:
    """K4's launch on CUDA tensors (see ``march_descent``).  The skew
    table (and with the window the curve table) goes into shared memory
    where it fits; ``shared=False`` keeps it in device memory, which only
    the checks pass.  ``fast=False`` runs every float32 step exactly, not
    first on the fast paths of its divides, roots, atan2 and sin/cos (the
    same result; for the checks and the timings).  ``profile`` launches the float32 build that
    adds clock64 cycles by part of the step, and counts the steps run
    again exactly, the window's pieces and those run again exactly, into
    an (R, 8) int64 output whose columns ``DESCENT_PROFILE`` names."""
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
    K = spec.score_k
    if K < 0 or K > MAX_WINDOW or (K > 0 and K % 2 == 0):
        raise ValueError(f"score_k {K}: odd and at most {MAX_WINDOW}, or 0")
    if spec.max_steps < 0:
        raise ValueError(f"descent with max_steps={spec.max_steps}")
    mat, held = _mat_args(model, mat_flat, spec.s)
    if mat[7] != MAT_CURVES:
        raise ValueError("the descent reads the unified curve rows "
                         "(4 columns)")
    if profile and dt != torch.float32:
        raise TypeError("the descent's profiling build is float32 only")
    skew = _check("ray_skew", model.ray_skew, dt, dev,
                  tuple(model.ray_curves.shape))
    Z, X = model.shape
    s = spec.s
    rows, cols = (TZ, TX) if spec.grid else ((Z - 1) * s + 1, (X - 1) * s + 1)
    item = rec_ttf.element_size()
    smem_of = build_descent().alifmm_descent_smem
    tables_smem = bool(shared) and smem_of(K, 1, mat[2], item) <= MAX_SMEM
    smem = smem_of(K, int(tables_smem), mat[2], item)
    P = spec.max_steps + 2
    bx = torch.zeros((R, P), dtype=dt, device=dev)
    by = torch.zeros((R, P), dtype=dt, device=dev)
    length = torch.empty(R, dtype=torch.int64, device=dev)
    reason = torch.empty(R, dtype=torch.int64, device=dev)
    steps = torch.empty(R, dtype=torch.int64, device=dev)
    prof = (torch.zeros((R, len(DESCENT_PROFILE)), dtype=torch.int64,
                        device=dev) if profile else None)
    args = mat[:7] + [
        skew.data_ptr(), rec_ttf.data_ptr(),
        TZ * TX if rec_ttf.dim() == 3 else 0, TZ, TX, ttf_index.data_ptr(),
        src.data_ptr(), rec.data_ptr(), bx.data_ptr(), by.data_ptr(),
        length.data_ptr(), reason.data_ptr(), steps.data_ptr(), R, P,
        spec.max_steps, K, rows, cols, 1.0 if spec.grid else float(s),
        float(s), spec.step_scale * s, ((spec.step_scale + 3.0) * s) ** 2,
        (4.0 * s) ** 2, (1.6 * s) ** 2, (K - 1) / 2.0,
        spec.score_stride * s, int(tables_smem), int(fast),
        None if prof is None else prof.data_ptr()]
    out = (bx, by, length, reason, steps) + ((prof,) if profile else ())
    return Prepared("descent", _fn("alifmm_descent", dt, build_descent),
                    args, out,
                    held + (skew, rec_ttf, ttf_index, src, rec), dev,
                    dict(lanes=32, tables_smem=tables_smem, smem=smem))


def march_descent(model: gridlib.Model, mat_flat, rec_ttf, ttf_index,
                  source_xy, receiver_xy, spec):
    """March every ray by characteristic descent from source to end
    (``rays.descent_plain`` states the result): K4 in one launch on CUDA
    tensors, the plain twin on CPU tensors.  ``spec``: a
    ``rays.DescentSpec``.  ``ttf_index`` must lie within the field stack:
    ``trace_rays_descent`` checks that, the kernel does not."""
    if not rec_ttf.is_cuda:
        return rayslib.descent_plain(model, mat_flat, rec_ttf, ttf_index,
                                     source_xy, receiver_xy, spec)
    p = prepare_march_descent(model, mat_flat, rec_ttf, ttf_index,
                              source_xy, receiver_xy, spec)
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
                         smem=smem, mat_kind=mat[7], tap=TAP_BILINEAR))


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
    EXACT) on (n,) CUDA segments, with the material path of ``mat_flat``:
    what ``segment_time_quad3``, ``segment_time_quad``,
    ``_segment_time_walk`` and ``segment_time`` of ``rays.py`` compute.
    For checking the device functions; no entry point calls it."""
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
    block.  For K4 ``scorer`` is its ``score_k``."""
    if p.name == "descent":
        blocks = _fn("alifmm_descent_occupancy", dtype, build_descent)(
            scorer, int(len(p.out) > 5), p.plan["smem"])
        if blocks < 0:
            raise RuntimeError("no occupancy for descent")
        return blocks
    which = 0 if p.name == "march" else 1
    profile = p.name == "march" and len(p.out) > 5
    blocks = _fn("alifmm_occupancy", dtype)(which, scorer, p.plan["mat_kind"],
                                            p.plan["tap"], int(profile),
                                            p.plan["smem"])
    if blocks < 0:
        raise RuntimeError(f"no occupancy for {p.name}")
    return blocks
