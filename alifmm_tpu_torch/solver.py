"""Per-source travel-time fields with telescoped source refinement.

Counterpart of ``alifmm_tpu/solver.py``.  A small window around each
source is solved on a refined grid, each stage seeding the next by
injecting every third point; the innermost window is seeded analytically
with straight rays through the source cell; the final stage solves the
whole grid.  With ``subgrid_size == 1`` the windows are refined 27x, 9x
and 3x and the final grid is the model's; with ``subgrid_size = s > 1``
(the reference's travel_finer_grid) the whole model is refined s times
first (``grid.refine_model``, on the model's device) and the windows of
``fine_stage_params`` are refined 9x and 3x on it.  Every stage is a
two-phase fixpoint of line sweeps (``ops/cuda_sweep.solve_fixpoint``: the
sweep kernel K1 on the GPU, its plain twin on the CPU).

Where the JAX package vmaps over sources, this module carries an explicit
source batch: patch models hold (B, Zp, Xp) material fields and the patch
fixpoints stop per source; the final stage solves the (B, Z, X) batch
with one joint stop test, as the JAX package does.  Every sweep form of
``SolveConfig`` runs (the operators, the parallel-in-block sweeps, the
two-loop fixpoint, the multigrid start of the final stage), through K1 on
the GPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings

import torch

from . import grid as gridlib
from . import materials as mats
from .ops import cuda_sweep
from .ops._math import sqrt
from .ops.stencils import INF
from .utils.profiling import span, spanned

__all__ = ["SolveConfig", "solve_ttf", "solve_one", "coarse_stages",
           "fine_stage_params"]


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Solver iteration budget and sweep forms: the JAX package's
    SolveConfig, field for field, with its defaults.

    ``use_ali`` (default True) is the operator of every pass: the ALI
    update with the FD fallback, or (False) the FD fallback alone.
    ``phase1_use_ali`` (None: ``use_ali``) gives phase 1 an operator of
    its own (the two-loop fixpoint: an FD envelope, then the ALI polish,
    for concave shear modes).  ``final_polish_fd=False`` drops the FD
    fallback from the final stage's polish (its points keep their phase-1
    value where no ALI stencil applies); patches always keep it.
    ``sweep_inner``/``patch_inner`` = J > 0 run phase 1 of the final
    stage/the patches as parallel-in-block sweeps, J iterations over
    blocks of ``sweep_block``/``patch_block`` lines (at least 2, else the
    order stays strict; with J = 0 the block sizes change nothing).
    ``multigrid`` starts the final stage from a 3x-decimated joint solve
    (``mg_passes`` phase-1 and ``mg_polish`` polish passes), prolonged
    bilinearly where the injection left points unknown; the JAX package
    measured it to degrade accuracy and warns, as this port does."""

    rel_tol: float = 1e-3
    patch_max_passes: int = 10
    final_max_passes: int = 16
    polish_passes: int = 5
    final_rel_tol: float | None = None
    final_polish_passes: int | None = None
    final_max_polish: int | None = None
    stage3_half: int | None = None
    sweep_block: int = 8
    patch_block: int = 4
    sweep_inner: int = 0
    patch_inner: int = 0
    use_ali: bool = True
    phase1_use_ali: bool | None = None
    final_polish_fd: bool = True
    multigrid: bool = False
    mg_passes: int = 12
    mg_polish: int = 2

    @classmethod
    def accuracy(cls, **overrides) -> "SolveConfig":
        """Accuracy preset: a tight phase-1 gate, larger pass budgets and a
        residual-driven final polish (the JAX package's preset, field for
        field).  ``overrides`` replace preset fields; an unknown field
        raises TypeError, as the dataclass does."""
        kw = dict(rel_tol=2e-4, patch_max_passes=16, final_max_passes=32,
                  polish_passes=8, final_rel_tol=2e-4,
                  final_polish_passes=8, final_max_polish=32)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def for_mode(cls, mode: str = "qp", **overrides) -> "SolveConfig":
        """Budget preset per wave mode (any case): ``qp``/``p``/``l`` the
        defaults; the shear modes ``qsv``/``qsh``/``sv``/``sh``/``s``/``t``
        24 patch passes, 96 final phase-1 passes, 8 polish passes and a
        residual-driven final polish of up to 96, since shear fields settle
        far slower under the line sweeps.  Any other mode raises
        ValueError.  ``overrides`` as in ``accuracy``.  Check the
        converged flag of ``solve_ttf(..., return_info=True)``."""
        m = mode.lower()
        if m in ("qp", "p", "l"):
            kw = {}
        elif m in ("qsv", "qsh", "sv", "sh", "s", "t"):
            kw = dict(patch_max_passes=24, final_max_passes=96,
                      polish_passes=8, final_polish_passes=8,
                      final_max_polish=96)
        else:
            raise ValueError(f"unknown wave mode {mode!r}")
        kw.update(overrides)
        return cls(**kw)


def _window_origin(center, half, n):
    """Clamped origin of a (2*half+1)-wide window around ``center``."""
    return torch.clamp(center - half, 0, max(n - 1 - 2 * half, 0))


def _slice_model(model: gridlib.Model, bz, bx, hz, hx, factor):
    """Per-source (2hz+1, 2hx+1) windows of the model at origins (bz, bx),
    NN-refined by ``factor`` with the reference dtype quirks (veln through
    int32, vel_map through float32).  Returns a batched patch Model."""
    dtype = model.dtype
    wz, wx = 2 * hz + 1, 2 * hx + 1
    iz = gridlib._nearest_index(wz, factor, model.device)
    ix = gridlib._nearest_index(wx, factor, model.device)
    rows = (bz[:, None] + iz[None, :])[:, :, None].long()
    cols = (bx[:, None] + ix[None, :])[:, None, :].long()
    veln_f = model.veln[rows, cols].to(torch.int32).to(dtype)
    velpn_f = model.velpn[rows, cols]
    vel_map_f = model.vel_map[rows, cols].to(torch.float32).to(dtype)
    stif_f = model.stif[rows, cols]
    fb = gridlib._fallback_slowness_planes(
        veln_f, velpn_f, vel_map_f, stif_f, model.group_tab, model.has_stif)
    return gridlib.Model(
        veln=veln_f, velpn=velpn_f, vel_map=vel_map_f, stif=stif_f,
        group_tab=model.group_tab, phase_tab=model.phase_tab,
        fallback_slowness=fb, dnx=model.dnx / factor, ray_curves=None,
        ray_curve_idx=None, ray_skew=None, has_stif=model.has_stif,
        phase_info=model.phase_info, group_info=model.group_info,
    )


def _analytic_seed(patch: gridlib.Model, base: gridlib.Model, isz, isx,
                   src_z, src_x, side, seed_sign):
    """Straight-ray times through the homogeneous source cell on each
    source's innermost patch.  ``(src_z, src_x)``: (B,) source positions on
    the patch grid; materials come from the base-grid source cell
    ``(isz, isx)``.  Returns (tt, fixed), both (B, Zp, Xp)."""
    dtype = base.dtype
    Z, X = patch.shape
    dev = base.device
    dz = (torch.arange(Z, dtype=dtype, device=dev)[None, :, None]
          - src_z.to(dtype)[:, None, None])
    dx = (torch.arange(X, dtype=dtype, device=dev)[None, None, :]
          - src_x.to(dtype)[:, None, None])
    dz, dx = torch.broadcast_tensors(dz, dx)
    in_seed = (torch.abs(dz) <= side) & (torch.abs(dx) <= side)

    dx_zero = dx == 0
    angle = torch.where(
        dx_zero, 90.0,
        torch.atan(dz / torch.where(dx_zero, 1.0, dx)) * (180.0 / math.pi))
    isz, isx = isz.long(), isx.long()
    v_src = base.veln[isz, isx][:, None, None]
    p_src = base.velpn[isz, isx][:, None, None]
    m_src = base.vel_map[isz, isx][:, None, None]
    s_src = base.stif[isz, isx][:, None, None, :]
    eff = torch.remainder(v_src + seed_sign * angle, 180.0)
    v_tab = mats.interp_table(patch.group_tab, eff, p_src.expand(dz.shape),
                              m_src.expand(dz.shape), info=patch.group_info)
    if patch.has_stif:
        v_chr = mats.group_velocity_christoffel(
            eff, *[s_src[..., c] for c in range(5)], m_src)
        vel = torch.where(p_src != 0, v_tab, v_chr)
    else:
        vel = v_tab
    tt = patch.dnx * sqrt(dz * dz + dx * dx) / vel
    tt = torch.where(in_seed, tt, INF)
    return tt, in_seed


def _edge_time(tt, bz, bx, prev_factor, base_shape):
    """Per-source first-arrival time on the real (not model-boundary)
    borders of the patch fields ``tt`` (B, Zp, Xp) at origins (bz, bx)."""
    Zp, Xp = tt.shape[-2], tt.shape[-1]
    Z, X = base_shape
    wz = (Zp - 1) // prev_factor
    wx = (Xp - 1) // prev_factor
    big = torch.where(tt < INF * 0.5, tt, INF)
    inf = torch.full_like(big[:, 0, 0], INF)
    t_top = torch.where(bz == 0, inf, big[:, 0, :].amin(-1))
    t_bot = torch.where(bz + wz >= Z - 1, inf, big[:, -1, :].amin(-1))
    t_left = torch.where(bx == 0, inf, big[:, :, 0].amin(-1))
    t_right = torch.where(bx + wx >= X - 1, inf, big[:, :, -1].amin(-1))
    return torch.minimum(torch.minimum(t_top, t_bot),
                         torch.minimum(t_left, t_right))


def _inject(prev_tt, prev_bz, prev_bx, prev_factor, cur_shape, cur_bz, cur_bx,
            cur_factor, base_shape):
    """Inject every third point of the previous stage's fields into the
    current grids; values at or below the first arrival on the previous
    patch's real borders are frozen.  Returns (tt, fixed), (B, *cur_shape)."""
    B = prev_tt.shape[0]
    dev = prev_tt.device
    sub = prev_tt[:, ::3, ::3]
    t_edge = _edge_time(prev_tt, prev_bz, prev_bx, prev_factor, base_shape)
    Sz, Sx = sub.shape[-2], sub.shape[-1]
    Zc, Xc = cur_shape
    # dynamic_update_slice semantics: the start is clamped so the update fits
    off_z = torch.clamp((prev_bz - cur_bz) * cur_factor, 0, Zc - Sz).long()
    off_x = torch.clamp((prev_bx - cur_bx) * cur_factor, 0, Xc - Sx).long()
    rows = (off_z[:, None] + torch.arange(Sz, device=dev)[None, :])[:, :, None]
    cols = (off_x[:, None] + torch.arange(Sx, device=dev)[None, :])[:, None, :]
    bidx = torch.arange(B, device=dev)[:, None, None]
    tt = torch.full((B, Zc, Xc), INF, dtype=prev_tt.dtype, device=dev)
    tt[bidx, rows, cols] = sub
    fixed = torch.zeros((B, Zc, Xc), dtype=torch.bool, device=dev)
    fixed[bidx, rows, cols] = sub <= t_edge[:, None, None]
    return tt, fixed


# Coarse-path constants: windows of +-2/+-6/+-13 cells at 27x/9x/3x; the
# analytic seed out to +-13 fine points; effective seed angle veln - angle.
_COARSE_STAGES = ((2, 27), (6, 9), (13, 3))
_COARSE_SEED_SIDE = 13
_COARSE_SEED_SIGN = -1.0


def coarse_stages(cfg: SolveConfig):
    """The coarse-path stage schedule, with cfg.stage3_half applied."""
    if cfg.stage3_half is None:
        return _COARSE_STAGES
    return _COARSE_STAGES[:-1] + ((cfg.stage3_half, 3),)


# Fine-path seed sign: effective seed angle veln + angle (travel_finer_grid
# against travel's veln - angle, a quirk of the reference kept as is).
_FINE_SEED_SIGN = 1.0


def fine_stage_params(subgrid_size: int):
    """Stage schedule of the fine path for ``subgrid_size`` s: windows of
    2s + (s - 1) // 2 and that plus 3s cells of the refined grid at 9x and
    3x, and the analytic seed's side, in the innermost patch's points."""
    s = subgrid_size
    size1 = 2 * s + (s - 1) // 2
    side1 = (9 - 1) // 2 + 9 * ((s - 1) // 2)
    size2 = size1 + 3 * s
    return ((size1, 9), (size2, 3)), side1


def _source_cells(model, scx, scz):
    isx = torch.round(scx / model.dnx).to(torch.int32)
    isz = torch.round(scz / model.dnx).to(torch.int32)
    return isz, isx


def _patch_solve(tt, patches, fixed, cfg):
    """Per-source fixpoint of a batch of patches (the polish always with
    the FD fallback: patches feed the injection)."""
    return cuda_sweep.solve_fixpoint(
        tt, patches, fixed, rel_tol=cfg.rel_tol,
        max_passes=cfg.patch_max_passes, polish_passes=cfg.polish_passes,
        per_source=True, block=cfg.patch_block, inner=cfg.patch_inner,
        use_ali=cfg.use_ali, phase1_use_ali=cfg.phase1_use_ali,
    )


def _window(model, isz, isx, half):
    Z, X = model.shape
    hz = min(half, (Z - 1) // 2)
    hx = min(half, (X - 1) // 2)
    return hz, hx, _window_origin(isz, hz, Z), _window_origin(isx, hx, X)


def _stage_first(model, scx, scz, half, factor, seed_side, seed_sign, cfg):
    """Innermost patches: analytic seed, then the patch fixpoint.  Returns
    (tt, bz, bx, per-source SolveInfo)."""
    isz, isx = _source_cells(model, scx, scz)
    hz, hx, bz, bx = _window(model, isz, isx, half)
    patches = _slice_model(model, bz, bx, hz, hx, factor)
    tt, fixed = _analytic_seed(patches, model, isz, isx, (isz - bz) * factor,
                               (isx - bx) * factor, seed_side, seed_sign)
    tt, info = _patch_solve(tt, patches, fixed, cfg)
    return tt, bz, bx, info


def _stage_next(model, scx, scz, prev_tt, prev_bz, prev_bx, half, factor, cfg):
    """Next patches, seeded by injection from the previous stage."""
    isz, isx = _source_cells(model, scx, scz)
    hz, hx, bz, bx = _window(model, isz, isx, half)
    patches = _slice_model(model, bz, bx, hz, hx, factor)
    tt, fixed = _inject(prev_tt, prev_bz, prev_bx, 3 * factor, patches.shape,
                        bz, bx, factor, model.shape)
    tt, info = _patch_solve(tt, patches, fixed, cfg)
    return tt, bz, bx, info


def _final_inputs(model, prev_tt, prev_bz, prev_bx):
    """The final stage's seed: the last patches injected into the whole
    grid.  Returns (tt, fixed), (B, Z, X)."""
    B = prev_tt.shape[0]
    zero = torch.zeros(B, dtype=prev_bz.dtype, device=prev_bz.device)
    return _inject(prev_tt, prev_bz, prev_bx, 3, model.shape, zero, zero, 1,
                   model.shape)


def _final_budget(cfg):
    """The final stage's two-phase budget: rel_tol, max_passes,
    polish_passes and max_polish_passes from ``cfg``."""
    return dict(
        rel_tol=cfg.rel_tol if cfg.final_rel_tol is None else cfg.final_rel_tol,
        max_passes=cfg.final_max_passes,
        polish_passes=(cfg.polish_passes if cfg.final_polish_passes is None
                       else cfg.final_polish_passes),
        max_polish_passes=cfg.final_max_polish)


def _decimate_model(model: gridlib.Model, c: int) -> gridlib.Model:
    """Stride-``c`` decimation of a model (coarse node k at fine node c k),
    for the multigrid start only: the ray tables are dropped."""
    return gridlib.Model(
        veln=model.veln[::c, ::c], velpn=model.velpn[::c, ::c],
        vel_map=model.vel_map[::c, ::c], stif=model.stif[::c, ::c],
        group_tab=model.group_tab, phase_tab=model.phase_tab,
        fallback_slowness=model.fallback_slowness[:, ::c, ::c],
        dnx=model.dnx * c, ray_curves=None, ray_curve_idx=None,
        ray_skew=None, has_stif=model.has_stif, phase_info=model.phase_info,
        group_info=model.group_info)


def _prolong3(tt_c, Z, X):
    """The exact bilinear 3x prolongation of (B, Zc, Xc) fields, coarse
    node k on fine node 3k, cut to (B, Z, X): the JAX package's nine
    weighted combinations, in its order of operations."""
    B, Zc, Xc = tt_c.shape
    t = torch.cat([tt_c, tt_c[:, -1:, :]], 1)
    t = torch.cat([t, t[:, :, -1:]], 2)
    rows = []
    for rz in range(3):
        wz = rz / 3.0
        cols = []
        for rx in range(3):
            wx = rx / 3.0
            cols.append((1 - wz) * (1 - wx) * t[:, :Zc, :Xc]
                        + (1 - wz) * wx * t[:, :Zc, 1: Xc + 1]
                        + wz * (1 - wx) * t[:, 1: Zc + 1, :Xc]
                        + wz * wx * t[:, 1: Zc + 1, 1: Xc + 1])
        rows.append(torch.stack(cols, -1).reshape(B, Zc, 3 * Xc))
    up = torch.stack(rows, 2).reshape(B, 3 * Zc, 3 * Xc)
    return up[:, :Z, :X]


MULTIGRID_WARNING = (
    "SolveConfig.multigrid is experimental and known to DEGRADE "
    "accuracy (up to 7e-2 relative error on the weld workload: the "
    "prolonged coarse guess undershoots and the monotone phase-1 "
    "sweep cannot raise it) with no measured speedup; do not use "
    "for production solves.")


def _multigrid_start(model, tt, fixed, cfg):
    """The final stage's multigrid start: a joint fixpoint on the
    3x-decimated model (the default operator, ``mg_passes`` and
    ``mg_polish``), prolonged into the points the injection left
    unknown."""
    warnings.warn(MULTIGRID_WARNING, stacklevel=3)
    Z, X = model.shape
    tt_c, _ = cuda_sweep.solve_fixpoint(
        tt[:, ::3, ::3].contiguous(), _decimate_model(model, 3),
        fixed[:, ::3, ::3].contiguous(), rel_tol=cfg.rel_tol,
        max_passes=cfg.mg_passes, polish_passes=cfg.mg_polish)
    return torch.where(tt < INF * 0.5, tt, _prolong3(tt_c, Z, X))


def _stage_final(model, prev_tt, prev_bz, prev_bx, cfg):
    """Full-grid stage: inject (and, with ``cfg.multigrid``, start from the
    decimated solve), then one joint fixpoint over all sources."""
    tt, fixed = _final_inputs(model, prev_tt, prev_bz, prev_bx)
    if cfg.multigrid:
        tt = _multigrid_start(model, tt, fixed, cfg)
    return cuda_sweep.solve_fixpoint(
        tt, model, fixed, **_final_budget(cfg), block=cfg.sweep_block,
        inner=cfg.sweep_inner, use_ali=cfg.use_ali,
        phase1_use_ali=cfg.phase1_use_ali, polish_use_fd=cfg.final_polish_fd,
    )


def solve_one(model: gridlib.Model, scx, scz, stages, seed_side: int,
              seed_sign: float, cfg: SolveConfig = SolveConfig()):
    """Travel-time field (Z, X) of one source at (scx, scz) on ``model``'s
    grid: ``stages`` are (window half size, refinement factor) pairs,
    innermost first, the factors stepping down by 3 to 3, then the final
    full-grid stage.

    The JAX package's single-source driver, which differs from the batched
    ``solve_ttf`` in what it reads of ``cfg``: it takes the operators
    (``use_ali``, ``phase1_use_ali``), but its final stage runs the
    fixed-count polish (``final_max_polish`` is ignored) with the FD
    fallback (``final_polish_fd`` is ignored) and no multigrid start
    (``multigrid`` is ignored), and its sweeps are strictly ordered
    (``sweep_inner`` and ``patch_inner`` are ignored); the stages come
    from the caller (``stage3_half`` is ignored)."""
    cfg = dataclasses.replace(cfg, final_max_polish=None,
                              final_polish_fd=True, sweep_inner=0,
                              patch_inner=0, multigrid=False)
    scx = torch.as_tensor(scx, device=model.device).to(model.dtype)
    scz = torch.as_tensor(scz, device=model.device).to(model.dtype)
    return _staged_solve(model, scx.reshape(1), scz.reshape(1), stages,
                         seed_side, seed_sign, cfg)[0]


def _staged_solve(base, scx, scz, stages, seed_side, seed_sign, cfg,
                  progress=None, return_info=False):
    """Telescoped solve of all sources: ``stages`` are (half, factor) pairs,
    innermost first, then the final full-grid stage."""
    total = len(stages) + 1
    scx = torch.as_tensor(scx, device=base.device).to(base.dtype)
    scz = torch.as_tensor(scz, device=base.device).to(base.dtype)

    def note(k, name, t0):
        if progress is None:
            return
        if base.device.type == "cuda":
            torch.cuda.synchronize(base.device)
        progress(stage=k, total=total, name=name,
                 seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    (h0, f0) = stages[0]
    with span("stage.first"):
        tt, bz, bx, _ = _stage_first(base, scx, scz, h0, f0, seed_side,
                                     float(seed_sign), cfg)
    note(1, f"patch {f0}x (half={h0})", t0)
    for k, (h, f) in enumerate(stages[1:], start=2):
        t0 = time.perf_counter()
        with span("stage.next"):
            tt, bz, bx, _ = _stage_next(base, scx, scz, tt, bz, bx, h, f,
                                        cfg)
        note(k, f"patch {f}x (half={h})", t0)
    t0 = time.perf_counter()
    with span("stage.final"):
        out, info = _stage_final(base, tt, bz, bx, cfg)
    note(total, "final full-grid", t0)
    if return_info:
        return out, info
    return out


@spanned("solve")
def solve_ttf(model: gridlib.Model, scx, scz, subgrid_size: int = 1,
              cfg: SolveConfig = SolveConfig(), progress=None,
              return_info=False):
    """Travel-time fields for sources at coordinates (scx, scz): (n_src,
    Z, X) on the model grid with ``subgrid_size == 1``, (n_src, (Z - 1) s
    + 1, (X - 1) s + 1) on the refined grid with ``subgrid_size = s > 1``.

    ``progress(stage=, total=, name=, seconds=)`` is called after each
    stage, with the device synchronised first.  ``return_info=True`` also
    returns the final stage's SolveInfo (phase-1 passes, converged).
    Under a profiler the solve is the range ``alifmm.solve`` and its
    stages ``alifmm.stage.first``, ``.next`` and ``.final``
    (``utils/profiling.span``: no synchronisation).
    """
    s = int(subgrid_size)
    if s == 1:
        base, seed_sign = model, _COARSE_SEED_SIGN
        stages, seed_side = coarse_stages(cfg), _COARSE_SEED_SIDE
    else:
        base, seed_sign = gridlib.refine_model(model, s), _FINE_SEED_SIGN
        stages, seed_side = fine_stage_params(s)
    return _staged_solve(base, scx, scz, stages, seed_side, seed_sign, cfg,
                         progress=progress, return_info=return_info)
