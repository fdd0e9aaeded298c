"""K1, the sweep kernel on the GPU, and the fixpoint pass loop.

Counterpart of ``alifmm_tpu/ops/pallas_sweep.py``.  ``csrc/sweep.cu`` runs
one full pass (four directional Gauss-Seidel sweeps) for a batch of
sources, a cluster of C CTAs per source with G lanes per point
(``launch_config``), and returns each source's pass-to-pass delta and
scale.  It is compiled with ``nvcc`` for ``sm_90a`` into a library
with a plain C interface at first use, into ``alifmm_tpu_torch/_build/``,
and loaded with ``ctypes`` (``ops/_build.py``).

``sweep_pass`` is the wrapper: for CUDA tensors it launches K1 (and raises
on any failure), for CPU tensors it runs the plain twin
(``ops/sweep.gs_pass``).  ``LAUNCHES`` counts kernel launches.
``solve_fixpoint`` is the two-phase pass loop the solver calls; it reads
the per-pass delta and scale to the host once per pass.
"""

from __future__ import annotations

import ctypes
import os
import typing

import numpy as np
import torch

from .. import grid as gridlib
from .. import materials as mat
from . import _build, sweep

__all__ = ["LAUNCHES", "build", "launch_config", "pack_model", "sweep_pass",
           "solve_fixpoint"]

LAUNCHES = 0

SOURCE = os.path.join(_build.CSRC, "sweep.cu")
_LIB = None
BUILD_LOG = ""
# Launch shapes K1 is built for (csrc/sweep.cu): clusters of up to 8 CTAs
# per source, 4 or 8 lanes per point, width tiles of up to 1,020 points.
CLUSTER_SIZES = (8, 4, 2, 1)
LANE_COUNTS = (4, 8)
MIN_TILE = 8
MAX_TILE = 1020


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def build(verbose: bool = False):
    """Compile ``csrc/sweep.cu`` (once per process and source version) and
    return the loaded library.  ``verbose`` adds ``-Xptxas -v`` and keeps
    its report in ``BUILD_LOG``."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = _build.compile_library(SOURCE, "alifmm_sweep", verbose)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("alifmm_sweep_pass_f32", "alifmm_sweep_pass_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr,
                       i32, ptr, ptr, i32, ctypes.c_double, ptr, ptr, ptr,
                       ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    _LIB = lib
    return lib


class Packed(typing.NamedTuple):
    """A model's material planes and phase table in the kernel's layout."""

    planes: torch.Tensor      # (Bm, 12, Z, X): veln, velpn, vel_map, stif x5, fbs x4
    planes_t: torch.Tensor    # (Bm, 12, X, Z): the same, for the x-sweeps
    phase_tab: torch.Tensor   # (A, M) contiguous
    col_mode: torch.Tensor    # (M,) int32
    col_const: torch.Tensor   # (M,)
    has_stif: bool
    dnx: float


def pack_model(model: gridlib.Model) -> Packed:
    """Stack a (shared or per-source batched) model into kernel planes."""
    dt = model.dtype
    stif = model.stif
    cols = [model.veln, model.velpn.to(dt), model.vel_map]
    cols += [stif[..., c] for c in range(5)]
    cols += [model.fallback_slowness[..., f, :, :] for f in range(4)]
    planes = torch.stack(cols, dim=-3)
    if planes.dim() == 3:
        planes = planes[None]
    mode, const = mat.column_modes(model.phase_info, model.phase_tab.shape[1])
    dev = model.device
    return Packed(
        planes=planes.contiguous(),
        planes_t=planes.transpose(-1, -2).contiguous(),
        phase_tab=model.phase_tab.contiguous(),
        col_mode=torch.from_numpy(mode).to(dev),
        col_const=torch.from_numpy(const).to(dt).to(dev),
        has_stif=bool(model.has_stif),
        dnx=float(model.dnx),
    )


def launch_config(B: int, Z: int, X: int, sms: int,
                  cluster: int | None = None, lanes: int | None = None):
    """K1's (cluster size C, lanes per point G) for B sources of (Z, X).

    A line step gives each SM about B * max(Z, X) / sms points.  Up to 32
    points per SM the step is latency-bound and G = 8 shortens it; above
    that it is bound by the SM's issue rate, and G = 4 (64 registers, two
    CTAs per SM) does less redundant work.  C is the largest of 8, 4, 2, 1
    that keeps all B x C CTAs resident at two per SM and width tiles of at
    least ``MIN_TILE`` points: C = 8 for the 31 weld sources at 424 x 500,
    109 x 109 and 79 x 79."""
    width = max(Z, X)
    if lanes is None:
        lanes = 8 if B * width <= 32 * sms else 4
    if cluster is None:
        cluster = 1
        for c in CLUSTER_SIZES:
            if B * c <= 2 * sms and -(-width // c) >= MIN_TILE:
                cluster = c
                break
    if cluster not in CLUSTER_SIZES or lanes not in LANE_COUNTS:
        raise ValueError(f"K1 takes clusters of {CLUSTER_SIZES} CTAs and "
                         f"{LANE_COUNTS} lanes per point, not {cluster} and "
                         f"{lanes}")
    if -(-width // cluster) > MAX_TILE:
        raise ValueError(f"K1 takes width tiles of up to {MAX_TILE} points, "
                         f"not {-(-width // cluster)} ({width} over "
                         f"{cluster} CTAs)")
    return cluster, lanes


def _launch(tt, fixed, packed, replace, active, cluster=None, lanes=None):
    """Launch K1 for (B, Z, X) CUDA fields; returns (new, delta, scale).
    ``cluster``/``lanes`` override ``launch_config``'s choice."""
    global LAUNCHES
    if tt.dim() != 3 or fixed.shape != tt.shape:
        raise ValueError(f"K1 takes (B, Z, X) fields and a fixed mask of the "
                         f"same shape, not {tuple(tt.shape)} and "
                         f"{tuple(fixed.shape)}")
    B, Z, X = tt.shape
    dt = tt.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64 fields, not {dt}")
    planes = packed.planes
    if planes.shape[-2:] != (Z, X) or planes.shape[0] not in (1, B):
        raise ValueError(f"material planes {tuple(planes.shape)} do not fit "
                         f"fields {tuple(tt.shape)}")
    for name, t in (("fixed", fixed), ("planes", planes),
                    ("phase_tab", packed.phase_tab)):
        if t.device != tt.device:
            raise ValueError(f"{name} is on {t.device}, fields on {tt.device}")
    if planes.dtype != dt or packed.phase_tab.dtype != dt:
        raise TypeError("material planes and fields differ in dtype")
    tt = tt.contiguous()
    fixed = fixed.to(torch.bool).contiguous()
    C, G = launch_config(B, Z, X, _sm_count(tt.device), cluster, lanes)
    out = torch.empty_like(tt)
    scratch = torch.empty_like(tt)
    delta = torch.empty(B, dtype=dt, device=tt.device)
    scale = torch.empty(B, dtype=dt, device=tt.device)
    rep = torch.as_tensor(np.asarray(replace, np.int32)).to(tt.device)
    act = torch.as_tensor(np.asarray(active, np.int32)).to(tt.device)
    bstride = 0 if planes.shape[0] == 1 else planes[0].numel()
    lib = build()
    fn = lib.alifmm_sweep_pass_f32 if dt == torch.float32 else lib.alifmm_sweep_pass_f64
    stream = torch.cuda.current_stream(tt.device).cuda_stream
    err = fn(tt.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             fixed.data_ptr(), planes.data_ptr(), packed.planes_t.data_ptr(),
             bstride, packed.phase_tab.data_ptr(),
             packed.phase_tab.shape[1], packed.col_mode.data_ptr(),
             packed.col_const.data_ptr(), int(packed.has_stif), packed.dnx,
             rep.data_ptr(), act.data_ptr(), delta.data_ptr(),
             scale.data_ptr(), B, Z, X, C, G, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, delta, scale


def sweep_pass(tt, model: gridlib.Model, fixed, replace, active=None,
               packed: Packed | None = None):
    """One sweep pass over (B, Z, X) fields: K1 on a CUDA tensor, the plain
    twin on a CPU tensor.  ``replace``/``active``: per-source flags
    (inactive sources keep their field).  Returns (new, delta, scale) with
    per-source delta and scale as host arrays."""
    B = tt.shape[0]
    replace = np.array(np.broadcast_to(np.asarray(replace, bool), (B,)))
    active = (np.ones(B, bool) if active is None
              else np.array(np.broadcast_to(np.asarray(active, bool), (B,))))
    if not tt.is_cuda:
        return sweep.plain_pass(tt, model, fixed, replace, active)
    packed = pack_model(model) if packed is None else packed
    out, delta, scale = _launch(tt, fixed, packed, replace, active)
    return out, delta.cpu().numpy(), scale.cpu().numpy()


def solve_fixpoint(tt0, model: gridlib.Model, fixed, rel_tol: float = 1e-6,
                   max_passes: int = 50, min_passes: int = 2,
                   polish_passes: int = 5, max_polish_passes: int | None = None,
                   per_source: bool = False, inner: int = 0,
                   use_ali: bool = True, phase1_use_ali: bool | None = None,
                   polish_use_fd: bool = True):
    """Two-phase fixpoint solve of (B, Z, X) fields through ``sweep_pass``.

    ``per_source=False``: one joint stop test over the batch (the final
    stage).  ``per_source=True``: each source has its own phase, pass count
    and stop test, and ``model`` may carry per-source material fields (the
    patch stages).  Returns (field, SolveInfo)."""
    sweep.check_form(inner, use_ali, phase1_use_ali, polish_use_fd)
    packed = pack_model(model) if tt0.is_cuda else None

    def pass_fn(tt, rep, act):
        return sweep_pass(tt, model, fixed, rep, act, packed=packed)

    return sweep.two_phase(tt0, pass_fn, per_source, rel_tol, max_passes,
                           min_passes, polish_passes, max_polish_passes)
