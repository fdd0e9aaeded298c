"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no fallback to the CPU):

1. device check: a CUDA device must be present; prints nvidia-smi's name
   and power limit;
2. builds the kernels from ``alifmm_tpu_torch/csrc`` with nvcc, one
   compiler per source, both at once: the sweep kernel K1 (``sweep.cu``)
   and the ray kernels K2 and K3 (``rays.cu``); prints ptxas' registers
   and spills per kernel;
3. holds K1 against its plain PyTorch twin on the card, in float64 and
   float32: a min pass and a replace pass on each case of ``PASS_CASES``
   (48 x 56, per-source weld patches of 109 x 109 and 79 x 79, narrow
   5 x 7 and 37 x 131 with ragged and empty width tiles, a tie-heavy
   isotropic 64 x 64) at several launch shapes, and a full fixpoint on
   48 x 56 (equal pass counts in float64);
4. holds the ray kernels against their plain twins on the card, in
   float64 and float32: the four segment integrators on seeded segments
   over the 48 x 56 and the weld model (``check_segments``), and on
   48 x 56 the march with the weld's knobs, with the facade's defaults
   and with Simpson 5 on a narrow plane (32 and 64 lanes a ray, the curve
   table in shared and in device memory, and through the wrapper
   ``cuda_rays.march``), then K3 on the marched polylines: one wave of
   each parity and scorer, and 0, 1 and 2 wave pairs with every scorer
   followed by the ray times, with the curve table and the polyline in
   shared and in device memory and through the wrapper
   ``cuda_rays.relax_and_times`` (``check_march``);
5. analytic check at full size: homogeneous isotropic 424 x 500, one
   interior source, relative error against r / v;
6. the weld slice at full size in float32, 31 receiver fields and 961
   rays: first the direct path (``solve_ttf`` + ``trace_rays``; a warm-up
   run, then a timed one), then through the facade
   (``ALI_FMM.find_all_TTF_rays_parallel``; a warm-up call, then a timed
   one with every launch count set to 0 just before it);
7. the ray kernels at the weld shape, with the weld's knobs and with the
   facade's defaults: K2 and K3 against their twins on the fields just
   solved (float32 and float64; K3 also on the facade defaults' long
   polylines, whose float64 copy needs the shared-memory opt-in), each
   timed warm (CUDA events) as a bare launch with its outputs allocated
   beforehand and through its wrapper, beside its bound and its twin's
   time; the march's bound counts the candidates and material samples
   of the steps the rays took (``plain_march``); the march's step split
   by part (clock64, a float32 build that only this phase launches) and
   the blocks resident per SM;
8. K1 timed warm (CUDA events) on each stage's input of the weld solve
   (31 x 109 x 109 twice, 31 x 79 x 79, 31 x 424 x 500; float32) beside
   its bound, at its own launch shape and at every other one; one plain
   pass at the final shape, timed and compared.

The last lines are the card line, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

TOL_PASS = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_SOLVE = {torch.float64: 1e-10, torch.float32: 1e-4}
# The local update's fp32 operations per point, counted from csrc/sweep.cu
# (8 square stencils ~31, 8 triangular ~35, 8 FD quadrants ~30, 8 knight
# pairs ~20, then atan, two floor-mods and the phase velocity), and the
# H100's non-tensor fp32 peak and memory rate (SXM data sheet, 700 W).
OPS_PER_UPDATE = 1000
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# tests/test_analytic_truth.py: isotropic envelope bounds (max, mean)
ANALYTIC_MAX, ANALYTIC_MEAN = 2.4e-2, 1.5e-2
# production budgets and march knobs of the weld workload
SOLVE_KW = dict(final_rel_tol=3e-3, final_polish_passes=2,
                patch_max_passes=8, polish_passes=4, sweep_block=4,
                patch_block=2)
RAY_OPTS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                relax_iters=1, relax_quad=3, max_steps=115, cand_stride=7.0)
# Ray kernels against their twins.  The kernels follow the twins operation
# for operation, sums included (Simpson samples in sample order, crossing
# intervals in sorted order, walk steps in step order), so the differences
# are expected to be 0 and are printed.  Held to:
# - segment integrators and relaxation waves: 1e-12 (float64) and 1e-5
#   (float32) relative, the room a differently ordered sum would need;
# - ray times: the same, because the kernel adds a ray's segments in a
#   fixed tree and the twin with torch.sum, whose order is not stated;
# - the march in float64: lengths, reasons and step counts equal and
#   vertices within 1e-9 fine cells;
# - the march in float32: a tie between candidates may flip on one ulp and
#   send a ray another way, so at least 99 % of the rays must equal the
#   twin's in length, reason, step count and every vertex (difference 0);
#   a ray that flipped and ends for the same reason must have a travel
#   time within 1e-4 relative of the twin's (production modes compare
#   times).  The largest vertex difference over all rays is printed and
#   goes into the kernels line.
TOL_SEG = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_VERTEX_F64 = 1e-9
TOL_TIME_F32 = 1e-4
MIN_EQUAL_F32 = 0.99
# Operations for the ray kernels' bounds, counted from the twins in
# alifmm_tpu_torch/rays.py: a material sample (cell index, row gather, two
# floor-mods, table interpolation, a divide) about 60, a segment's set-up
# (arctan, square root, divides) about 30, a bilinear field sample about
# 30, a step's plane geometry about 100, an interior column about 20.
OPS_SAMPLE, OPS_SEGMENT, OPS_BILINEAR, OPS_PLANE, OPS_COLUMN = 60, 30, 30, 100, 20
NO_LIBRARY = ("no PyTorch call computes a plane-search march or a "
              "cell-crossing integral")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    """Max absolute and relative difference over points known in either."""
    from alifmm_tpu_torch.ops.stencils import INF

    got = got.double().cpu()
    want = want.double().cpu()
    check(torch.equal(got < INF * 0.5, want < INF * 0.5),
          "kernel and plain twin disagree on which points are known")
    known = want < INF * 0.5
    d = (got - want).abs()[known]
    if d.numel() == 0:
        return 0.0, 0.0
    rel = d / want[known].abs().clamp_min(1e-12)
    return float(d.max()), float(rel.max())


def random_model(Z, X, dtype, device, seed=0):
    """A weld-like model: random integer orientations on a table material
    around a stiffness (Christoffel) block in the middle."""
    from alifmm_tpu_torch import grid

    rng = np.random.default_rng(seed)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.ones((Z, X), dtype=int)
    velpn[Z // 4: 3 * Z // 4, 2 * X // 7: 5 * X // 7] = 0
    vel_map = np.where(velpn == 1, 5790.0, 1.0)
    stif = np.zeros((Z, X, 5))
    stif[:, :] = [263000, 148000, 216000, 129000, 8100]
    return grid.make_model(veln, velpn, vel_map, stif, None, None, 2e-4,
                           dtype=dtype, device=device)


def small_model(dtype, device):
    """The 48 x 56 weld-like problem of __graft_entry__._small_problem."""
    return random_model(48, 56, dtype, device)


def seeded(shape, B, dtype, device):
    from alifmm_tpu_torch.ops.stencils import INF

    Z, X = shape
    tt = torch.full((B, Z, X), INF, dtype=dtype, device=device)
    fixed = torch.zeros((B, Z, X), dtype=torch.bool, device=device)
    for b in range(B):
        sz, sx = (7 * b + 3) % Z, (11 * b + 5) % X
        tt[b, sz, sx] = 0.0
        fixed[b, sz, sx] = True
    return tt, fixed


def weld_patches(half, factor, dtype, device):
    """Per-source patch models of the weld (three sources) with their
    analytic seeds: half 2 at 27x gives 109 x 109, half 13 at 3x 79 x 79."""
    from alifmm_tpu_torch import grid, solver, weld_data

    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
    model = grid.make_model(veln, velpn, vel_map, stif, None, None,
                            weld_data.DNX, dtype=dtype, device=device)
    scx = torch.tensor([100.0, 250.0, 400.0], dtype=dtype,
                       device=device) * weld_data.DNX
    scz = torch.tensor([423.0, 423.0, 200.0], dtype=dtype,
                       device=device) * weld_data.DNX
    isz, isx = solver._source_cells(model, scx, scz)
    hz, hx, bz, bx = solver._window(model, isz, isx, half)
    patches = solver._slice_model(model, bz, bx, hz, hx, factor)
    tt, fixed = solver._analytic_seed(
        patches, model, isz, isx, (isz - bz) * factor, (isx - bx) * factor,
        solver._COARSE_SEED_SIDE, solver._COARSE_SEED_SIGN)
    return patches, tt, fixed


def centred_isotropic(n, dtype, device):
    """Homogeneous isotropic n x n, one source in the centre: the square
    stencils' diffs tie exactly, so first-wins decides every point."""
    from alifmm_tpu_torch import grid
    from alifmm_tpu_torch.ops.stencils import INF

    model = grid.make_model(np.zeros((n, n)), np.ones((n, n), dtype=int),
                            5790.0 * np.ones((n, n)), None, None, None, 2e-4,
                            dtype=dtype, device=device)
    tt = torch.full((1, n, n), INF, dtype=dtype, device=device)
    fixed = torch.zeros((1, n, n), dtype=torch.bool, device=device)
    tt[0, n // 2, n // 2] = 0.0
    fixed[0, n // 2, n // 2] = True
    return model, tt, fixed


def _seeded_case(Z, X, B):
    def make(dtype, device):
        model = random_model(Z, X, dtype, device, seed=Z * 1000 + X)
        return (model, *seeded((Z, X), B, dtype, device))
    return make


# K1 launch shapes every case is checked at: (cluster, lanes), None = the
# wrapper's own choice.  The narrow cases also force clusters whose width
# tiles are ragged (37 = 5 x 7 + 2) or empty (5 over 4 CTAs of 2).
AUTO = [(None, 4), (None, 8)]
FORCED = AUTO + [(4, 4), (4, 8), (8, 8), (1, 8)]
PASS_CASES = {
    "48x56": (_seeded_case(48, 56, 3), AUTO),
    "patches 109x109": (lambda dt, dev: weld_patches(2, 27, dt, dev), AUTO),
    "patches 79x79": (lambda dt, dev: weld_patches(13, 3, dt, dev), AUTO),
    "5x7": (_seeded_case(5, 7, 3), FORCED),
    "37x131": (_seeded_case(37, 131, 3), FORCED),
    "tie-heavy isotropic 64x64": (
        lambda dt, dev: centred_isotropic(64, dt, dev), FORCED),
}


def check_pass(model, tt, fixed, replace, dtype, what, configs=AUTO):
    """One plain pass against K1 at each launch shape, on the same inputs.
    Returns the plain result and the largest absolute difference."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    new_p = sweep.gs_pass(tt, model, fixed, replace=replace)
    dp, sp = sweep.delta_scale(new_p, tt)
    packed = cuda_sweep.pack_model(model)
    B = tt.shape[0]
    rep = np.full(B, bool(replace))
    act = np.ones(B, bool)
    worst = 0.0
    for cluster, lanes in configs:
        C, G = cuda_sweep.launch_config(B, *tt.shape[1:], cuda_sweep._sm_count(
            tt.device), cluster, lanes)
        new_k, dk, sk = cuda_sweep._launch(tt, fixed, packed, rep, act, C, G)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(new_k, new_p)
        log(f"  {what} C={C} G={G}: max abs {abs_e:.3e} max rel {rel_e:.3e} "
            f"(tolerance {TOL_PASS[dtype]:.0e})")
        check(rel_e <= TOL_PASS[dtype],
              f"{what} C={C} G={G}: kernel differs from plain twin")
        np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(),
                                   rtol=TOL_PASS[dtype])
        np.testing.assert_allclose(sk.cpu().numpy(), sp.cpu().numpy(),
                                   rtol=TOL_PASS[dtype])
        worst = max(worst, abs_e)
    return new_p, worst


def check_case(name, dtype, device):
    """A min pass, then a replace pass on its result, K1 against the plain
    twin; returns the largest absolute difference."""
    make, configs = PASS_CASES[name]
    model, tt, fixed = make(dtype, device)
    dname = str(dtype).replace("torch.", "")
    mid, e1 = check_pass(model, tt, fixed, False, dtype,
                         f"{name} min {dname}", configs)
    _, e2 = check_pass(model, mid, fixed, True, dtype,
                       f"{name} replace {dname}", configs)
    return max(e1, e2)


def check_fixpoint(dtype, device):
    """The two-phase fixpoint through K1 against the plain loop (48 x 56);
    in float64 the pass counts must be equal."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    model = small_model(dtype, device)
    tt, fixed = seeded(model.shape, 3, dtype, device)
    name = str(dtype).replace("torch.", "")
    kw = dict(rel_tol=1e-3, max_passes=6, polish_passes=2)
    got, info_k = cuda_sweep.solve_fixpoint(tt, model, fixed, **kw)
    want, info_p = sweep.solve_fixpoint(tt, model, fixed, **kw)
    abs_e, rel_e = rel_err(got, want)
    log(f"  solve_fixpoint {name}: max abs {abs_e:.3e} max rel "
        f"{rel_e:.3e} (tolerance {TOL_SOLVE[dtype]:.0e}); passes kernel "
        f"{info_k.passes} plain {info_p.passes}")
    check(rel_e <= TOL_SOLVE[dtype], f"solve_fixpoint {name} differs")
    if dtype == torch.float64:
        check(info_k == info_p, "solve_fixpoint float64 pass counts differ")
    return abs_e


def phase_kernel_vs_plain(device):
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for name in PASS_CASES:
            worst = max(worst, check_case(name, dtype, device))
        worst = max(worst, check_fixpoint(dtype, device))
    return worst


# --------------------------------------------------------------------- #
# Ray kernels (K2, K3) against their plain twins
# --------------------------------------------------------------------- #

# march knobs by name: (trace_rays knobs, fine cells per model cell); on
# 48 x 56 they give 64 lanes a ray (Simpson 3, K = 15), 32 (walk, K = 21)
# and 32 (Simpson 5, K = 5)
MARCH_KNOBS = {
    "weld knobs": (RAY_OPTS, 9),
    "facade defaults": (dict(), 3),
    "simpson5 narrow plane": (dict(max_cross=8, step_scale=3, plane_dist=2,
                                   quad_vel=True, cand_stride=10.0,
                                   max_steps=60), 9),
}
# K3's relaxation scorers: (quad, name)
K3_SCORERS = ((3, "simpson3"), (True, "simpson5"), (0, "exact"))
RAY_MODELS = ("48x56", "weld")
# (name, integrator code of ops/cuda_rays.py, crossing budget)
SEGMENT_KINDS = (("simpson3", 0, 0), ("simpson5", 1, 0), ("walk", 2, 16),
                 ("walk 26", 2, 26), ("exact", 3, 8), ("exact 40", 3, 40))


def ray_model(name, dtype, device):
    """The models the ray kernels are checked on: the 48 x 56 weld-like
    problem or the full seeded weld."""
    from alifmm_tpu_torch import grid, weld_data

    if name == "48x56":
        return small_model(dtype, device)
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
    return grid.make_model(veln, velpn, vel_map, stif, None, None,
                           weld_data.DNX, dtype=dtype, device=device)


def seeded_segments(shape, s, n, seed, dtype, device):
    """n segments in fine-grid coordinates from a seed: up to 12 model
    cells long in any direction, with blocks that are vertical,
    horizontal, of zero length, leaving the grid, 40 cells long (more
    crossings than any budget here) and on integer fine-grid points."""
    rng = np.random.default_rng(seed)
    Z, X = shape
    x1 = rng.uniform(0, (X - 1) * s, n)
    y1 = rng.uniform(0, (Z - 1) * s, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.uniform(0, 12 * s, n)
    q = n // 8
    length[4 * q:5 * q] = 40 * s
    x1[3 * q:4 * q] = rng.uniform(-3 * s, 2 * s, q)
    y1[3 * q:3 * q + q // 2] = rng.uniform((Z - 3) * s, (Z + 2) * s, q // 2)
    x2 = x1 + length * np.cos(ang)
    y2 = y1 + length * np.sin(ang)
    x2[:q] = x1[:q]
    y2[q:2 * q] = y1[q:2 * q]
    x2[2 * q:2 * q + 16] = x1[2 * q:2 * q + 16]
    y2[2 * q:2 * q + 16] = y1[2 * q:2 * q + 16]
    pts = [x1, y1, x2, y2]
    for a in pts:
        a[5 * q:6 * q] = np.round(a[5 * q:6 * q])
    return [torch.as_tensor(a).to(dtype).to(device) for a in pts]


def worst_rel(got, want):
    """Largest |got - want| and the largest relative to |want| (0 where
    both are 0)."""
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), "kernel result not finite")
    d = (got - want).abs()
    rel = torch.where(d == 0, torch.zeros_like(d),
                      d / want.abs().clamp_min(1e-300))
    return float(d.max()), float(rel.max())


def check_segments(model_name, dtype, device, n=4096):
    """The kernels' four segment integrators against segment_time_quad3,
    segment_time_quad, _segment_time_walk and segment_time on seeded
    segments.  Returns the largest absolute difference."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    model = ray_model(model_name, dtype, device)
    mat_flat = rays._material_flat(model)
    dname = str(dtype).replace("torch.", "")
    worst = 0.0
    for s in (9, 3):
        pts = seeded_segments(model.shape, s, n, 17 + s, dtype, device)
        for name, kind, cross in SEGMENT_KINDS:
            if kind == cuda_rays.SIMPSON3:
                want = rays.segment_time_quad3(model, mat_flat, *pts, s)
            elif kind == cuda_rays.SIMPSON5:
                want = rays.segment_time_quad(model, mat_flat, *pts, s)
            elif kind == cuda_rays.WALK:
                want = rays._segment_time_walk(model, mat_flat, *pts, s, cross)
            else:
                want = rays.segment_time(model, mat_flat, *pts, s, cross)
            got = cuda_rays.segments(model, mat_flat, kind, *pts, s, cross)
            torch.cuda.synchronize()
            abs_e, rel_e = worst_rel(got, want)
            log(f"  segments {model_name} s={s} {name} {dname}: max abs "
                f"{abs_e:.3e} max rel {rel_e:.3e} (tolerance "
                f"{TOL_SEG[dtype]:.0e})")
            check(rel_e <= TOL_SEG[dtype],
                  f"segment integrator {name} differs from its twin")
            worst = max(worst, abs_e)
    return worst


def compare_march(got, want, model, mat_flat, s, final_cross, dtype, what):
    """A marched batch (bx, by, length, reason, steps) against the twin's,
    to the tolerances stated at the top.  Returns the largest vertex
    difference over all rays in fine cells, and the share of rays that
    are equal in length, reason, steps and every vertex."""
    from alifmm_tpu_torch.ops import cuda_rays

    gx, gy, glen, greason, gsteps = got
    wx, wy, wlen, wreason, wsteps = want
    per_ray = torch.maximum((gx - wx).abs().amax(1), (gy - wy).abs().amax(1))
    vertex = float(per_ray.max())
    same_reason = greason == wreason
    equal = (same_reason & (glen == wlen) & (gsteps == wsteps)
             & (per_ray == 0))
    share = float(equal.double().mean())
    log(f"  march {what}: largest vertex difference {vertex:.3e} fine "
        f"cells; rays equal in length, reason, steps and vertices "
        f"{share:.4f}, reasons agree "
        f"{float(same_reason.double().mean()):.4f}; steps max "
        f"{int(gsteps.max())} mean {float(gsteps.double().mean()):.1f}")
    if dtype == torch.float64:
        check(torch.equal(glen, wlen) and torch.equal(greason, wreason)
              and torch.equal(gsteps, wsteps),
              f"march {what}: lengths, reasons or steps differ")
        check(vertex <= TOL_VERTEX_F64, f"march {what}: vertices differ")
        return vertex, share
    check(share >= MIN_EQUAL_F32,
          f"march {what}: only {share:.4f} of the rays equal the twin's")
    flipped = ~equal & same_reason
    if bool(flipped.any()):
        gt = cuda_rays.ray_times(model, mat_flat, gx, gy, glen, s,
                                 final_cross)
        wt = cuda_rays.ray_times(model, mat_flat, wx, wy, wlen, s,
                                 final_cross)
        rel = ((gt - wt).abs() / wt.abs().clamp_min(1e-30))[flipped]
        log(f"    {int(flipped.sum())} rays took another path to the same "
            f"end: ray times max rel {float(rel.max()):.3e} (tolerance "
            f"{TOL_TIME_F32:.0e})")
        check(float(rel.max()) <= TOL_TIME_F32,
              f"march {what}: ray times of the flipped rays differ")
    return vertex, share


def check_k3(model, mat_flat, bx, by, length, s, cross, dtype, what,
             iters=(0, 1, 2), scorers=K3_SCORERS, single_waves=True):
    """K3 against its twins on the polylines (bx, by, length): one wave of
    each parity and scorer (``relax_wave``), then for each of ``iters``
    that many odd-even wave pairs with every scorer followed by the ray
    times, with the curve table and the polyline in shared memory and in
    device memory (bare launches) and through the wrapper
    ``relax_and_times``, as ``trace_rays`` calls it.  Returns the largest
    differences: vertices in fine cells, times in seconds and relative."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    tol = TOL_SEG[dtype]
    worst = dict(relax_vertices=0.0, relax_times=0.0, relax_times_rel=0.0)
    for quad, qname in scorers if single_waves else ():
        for parity in (1, 0):
            args = (model, mat_flat, bx, by, length, s, parity, float(s),
                    cross, quad)
            gx, gy = cuda_rays.relax_wave(*args)
            wx, wy = rays.relax_wave_plain(*args)
            torch.cuda.synchronize()
            check(not torch.equal(wx, bx), "the relaxation wave moved nothing")
            ax, rx = worst_rel(gx, wx)
            ay, ry = worst_rel(gy, wy)
            log(f"  K3 one wave {what} {qname} parity={parity}: max abs "
                f"{max(ax, ay):.3e} fine cells, max rel {max(rx, ry):.3e} "
                f"(tolerance {tol:.0e})")
            check(max(rx, ry) <= tol, f"K3 wave {what} {qname} differs")
            worst["relax_vertices"] = max(worst["relax_vertices"], ax, ay)
    for shared in (True, False):
        where = "shared" if shared else "device"
        for n in iters:
            for quad, qname in scorers if n else scorers[:1]:
                kw = dict(waves=2 * n, relax_cross=cross, quad=quad,
                          times_cross=cross)
                p = cuda_rays.prepare_relax_and_times(
                    model, mat_flat, bx, by, length, s, shared=shared, **kw)
                plan = p.plan
                check(plan["curves_smem"] == shared
                      and plan["poly_smem"] == (shared and n > 0),
                      f"K3 {what}: memory plan {plan}")
                p.run()
                runs = [(f"{where} memory ({plan['smem']} B)", p.out)]
                if shared:
                    runs.append(("through the wrapper",
                                 cuda_rays.relax_and_times(
                                     model, mat_flat, bx, by, length, s,
                                     **kw)))
                wx, wy, wt = rays.relax_and_times_plain(
                    model, mat_flat, bx, by, length, s, **kw)
                torch.cuda.synchronize()
                for how, (gx, gy, gt) in runs:
                    ax, rx = worst_rel(gx, wx)
                    ay, ry = worst_rel(gy, wy)
                    at, rt = worst_rel(gt, wt)
                    log(f"  K3 {what}, {n} wave pairs"
                        f"{' ' + qname if n else ''}, then times; {how}: "
                        f"vertices max abs {max(ax, ay):.3e} fine cells, max "
                        f"rel {max(rx, ry):.3e}; times max abs {at:.3e} s, "
                        f"max rel {rt:.3e} (tolerance {tol:.0e})")
                    check(max(rx, ry, rt) <= tol,
                          f"K3 {what} {n} pairs {qname} {how} differs")
                    worst["relax_vertices"] = max(worst["relax_vertices"],
                                                  ax, ay)
                    worst["relax_times"] = max(worst["relax_times"], at)
                    worst["relax_times_rel"] = max(worst["relax_times_rel"],
                                                   rt)
    return worst


def march_inputs(model, knobs, s, sx, sy, pairs, dnx):
    """(mat_flat, tidx, src_xy, rec_xy, spec, final_cross) of a march over
    ``pairs`` with trace_rays' ``knobs`` at ``s`` fine cells per model
    cell."""
    from alifmm_tpu_torch import rays, weld_data

    kw = dict(max_steps=None, max_cross=16, step_scale=1, quad_vel=False,
              cand_stride=1.0, plane_dist=3, near_step=1)
    kw.update({k: v for k, v in knobs.items() if k in kw})
    spec = rays.march_spec(model, s, **kw)
    _, _, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx, s)
    dev = model.device

    def on_dev(a, dt):
        return torch.as_tensor(a).to(dt).to(dev)

    final_cross = max(-(-kw["max_cross"] // 2) + 1, spec.k_step + 4)
    return (rays._material_flat(model), on_dev(tidx, torch.int64),
            on_dev(src_xy, model.dtype), on_dev(rec_xy, model.dtype), spec,
            final_cross)


def check_march(knobs_name, dtype, device):
    """On 48 x 56 (25 rays through 5 solved fields): the march kernel
    against march_plain, then the relaxation waves and ray times on its
    polylines.  Returns the largest differences by kernel."""
    from alifmm_tpu_torch import rays, solver, weld_data

    model = small_model(dtype, device)
    dnx = float(model.dnx)
    sx, sy, pairs = weld_data.transducers(model.shape, dnx, 5, 10)
    scx, scz = weld_data.ray_pairs(sx, sy, pairs, dnx)[:2]
    ttfs = solver.solve_ttf(model, torch.as_tensor(scx), torch.as_tensor(scz),
                            1, solver.SolveConfig(**SOLVE_KW))
    mat_flat, tidx, src, rec, spec, final_cross = march_inputs(
        model, *MARCH_KNOBS[knobs_name], sx, sy, pairs, dnx)
    args = (model, mat_flat, ttfs, tidx, src, rec, spec)
    want = rays.march_plain(*args)
    what = f"48x56 {knobs_name} {str(dtype).replace('torch.', '')}"
    errs = march_vs_twin(args, want, final_cross, dtype, what)
    merge_worst(errs, check_k3(model, mat_flat, *want[:3], spec.s,
                               final_cross, dtype, what))
    return errs


def march_vs_twin(args, want, final_cross, dtype, what):
    """K2 with the curve table in shared and in device memory (bare
    launches) and through the wrapper ``cuda_rays.march``, as
    ``trace_rays`` calls it, against the twin's result ``want``.  Returns
    the march's differences by key."""
    from alifmm_tpu_torch.ops import cuda_rays

    model, mat_flat, spec = args[0], args[1], args[-1]
    vertex, equal = 0.0, 1.0
    runs = []
    for shared in (True, False):
        p = cuda_rays.prepare_march(*args, shared=shared)
        check(p.plan["curves_smem"] == shared, f"march plan {p.plan}")
        p.run()
        runs.append((f"{p.plan['lanes']} lanes a ray, curves in "
                     f"{'shared' if shared else 'device'} memory", p.out))
    runs.append(("through the wrapper", cuda_rays.march(*args)))
    torch.cuda.synchronize()
    for how, got in runs:
        v, e = compare_march(got, want, model, mat_flat, spec.s, final_cross,
                             dtype, f"{what}, {how}")
        vertex, equal = max(vertex, v), min(equal, e)
    return dict(march=vertex, march_unequal=1.0 - equal)


def merge_worst(worst, errs):
    """Keep the largest difference by kernel, over both types."""
    for key, e in errs.items():
        worst[key] = max(worst.get(key, 0.0), e)


def phase_rays_vs_plain(device):
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for name in RAY_MODELS:
            merge_worst(worst, dict(segments=check_segments(
                name, dtype, device)))
        for knobs_name in MARCH_KNOBS:
            merge_worst(worst, check_march(knobs_name, dtype, device))
    return worst


def phase_analytic(device):
    from alifmm_tpu_torch import grid, solver

    Z, X, dnx, v = 424, 500, 2e-4, 5790.0
    model = grid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int),
                            v * np.ones((Z, X)), None, None, None, dnx,
                            dtype=torch.float32, device=device)
    sz, sx = 212, 250
    tt, info = solver.solve_ttf(model, torch.tensor([sx * dnx]),
                                torch.tensor([sz * dnx]), 1,
                                solver.SolveConfig(), return_info=True)
    got = tt[0].double().cpu().numpy()
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    want = dnx * np.hypot(zz - sz, xx - sx) / v
    mask = want > 0
    rel = np.abs(got - want)[mask] / want[mask]
    log(f"  isotropic 424x500: rel err max {rel.max():.4e} mean "
        f"{rel.mean():.4e} (bounds {ANALYTIC_MAX}, {ANALYTIC_MEAN}); final "
        f"passes {info.passes} converged {info.converged}")
    check(np.isfinite(got).all(), "analytic field not finite")
    check(rel.max() < ANALYTIC_MAX and rel.mean() < ANALYTIC_MEAN,
          "analytic error out of bounds")


def weld_inputs(device):
    from alifmm_tpu_torch import grid, weld_data

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    t0 = time.perf_counter()
    model = grid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                            dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    log(f"  model build {time.perf_counter() - t0:.3f} s")
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx)

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a).to(dt).to(device)

    return (model, dev(scx), dev(scz), dev(src_xy), dev(rec_xy),
            dev(tidx, torch.int64))


def run_slice(inputs, progress=None):
    from alifmm_tpu_torch import rays, solver, weld_data

    model, scx, scz, src_xy, rec_xy, tidx = inputs
    cfg = solver.SolveConfig(**SOLVE_KW)
    t0 = time.perf_counter()
    ttfs, info = solver.solve_ttf(model, scx, scz, 1, cfg, progress=progress,
                                  return_info=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = rays.trace_rays(model, ttfs, tidx, src_xy, rec_xy,
                          weld_data.SUBGRID, mode="interp",
                          return_reason=True, **RAY_OPTS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ttfs, info, out, (t1 - t0, t2 - t1, t2 - t0)


def reset_counts():
    """Set every kernel's launch count and every plain twin's count to 0."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays, cuda_sweep, sweep

    cuda_sweep.LAUNCHES = 0
    sweep.CALLS = 0
    rays.PLAIN_STEPS = 0
    for name in cuda_rays.LAUNCHES:
        cuda_rays.LAUNCHES[name] = 0


def read_counts():
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays, cuda_sweep, sweep

    return dict(sweep_pass=cuda_sweep.LAUNCHES, plain_passes=sweep.CALLS,
                plain_steps=rays.PLAIN_STEPS, **cuda_rays.LAUNCHES)


def check_counts(counts, what):
    """The run went through every kernel, K2 and K3 once each, and
    through no plain twin."""
    check(counts["sweep_pass"] > 0, f"{what} launched no sweep_pass kernel")
    for name in ("march", "relax_times"):
        check(counts[name] == 1,
              f"{what} launched {counts[name]} {name} kernels, not 1")
    check(counts["plain_passes"] == 0,
          f"{what} ran the plain sweep pass on the card")
    check(counts["plain_steps"] == 0,
          f"{what} ran plain march steps on the card")


def phase_slice(device):
    """The direct path: solve_ttf, then trace_rays, on device inputs."""
    from alifmm_tpu_torch.ops.stencils import INF

    inputs = weld_inputs(device)
    t0 = time.perf_counter()
    run_slice(inputs)
    log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    reset_counts()
    ttfs, info, out, (t_solve, t_rays, wall) = run_slice(inputs, rec)
    counts = read_counts()
    bx, by, lengths, times, reason = out
    log(f"  direct weld slice warm wall clock {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s)")
    for name, sec in stages:
        log(f"    stage [{name}] {sec:.4f} s")
    log(f"  final stage passes {info.passes} converged {info.converged}")
    log(f"  launches and plain-twin counts: {counts}")
    reasons = {int(k): int(v) for k, v in
               zip(*np.unique(reason.cpu().numpy(), return_counts=True))}
    log(f"  rays by reason (0 arrived, 1 plane left grid, 2 truncated): "
        f"{reasons}")
    check_counts(counts, "the direct weld slice")
    check(ttfs.shape == (31, 424, 500), f"field shape {tuple(ttfs.shape)}")
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          "weld fields not finite everywhere")
    check(times.shape == (961,), f"times shape {tuple(times.shape)}")
    check(bool(torch.isfinite(times).all()) and bool((times > 0).all()),
          "ray times not finite and positive")
    arrived = (reason == 0) & (lengths - 2 < RAY_OPTS["max_steps"])
    check(int(arrived.sum()) == 961,
          f"only {int(arrived.sum())} of 961 rays arrive")
    return inputs, ttfs, (wall, t_solve, t_rays)


def phase_facade(device):
    """The weld slice through ALI_FMM.find_all_TTF_rays_parallel: a warm-up
    call, then a timed one with every count set to 0 just before it."""
    import alifmm_tpu_torch
    from alifmm_tpu_torch import weld_data

    alifmm_tpu_torch.tqdm_disable = True  # a bar synchronises every stage
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy, stif_den=stif,
                                  dnx=dnx, ray_opts=RAY_OPTS,
                                  solve_opts=SOLVE_KW)
    builds = []
    make_model = fm._make_model

    def timed_make_model(*args):
        # the build ends in blocking copies to the card, so the
        # synchronise adds nothing to the call it is timed in
        t0 = time.perf_counter()
        model = make_model(*args)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return model

    fm._make_model = timed_make_model

    def call():
        del builds[:]
        t0 = time.perf_counter()
        out = fm.find_all_TTF_rays_parallel(veln, velpn, vel_map,
                                            stif_den=stif, trans_pairs=pairs,
                                            n_threads=8)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, t_warm = call()
    reset_counts()
    tmat, wall = call()
    counts = read_counts()
    check(len(builds) == 2, f"the facade built {len(builds)} models, not 2")
    log(f"  facade warm-up call {t_warm:.3f} s; timed call {wall:.4f} s, of "
        f"which its two model builds {builds[0]:.4f} and {builds[1]:.4f} s "
        f"(host numpy, timed inside the call)")
    log(f"  launches and plain-twin counts: {counts}")
    check_counts(counts, "the facade's weld run")
    top, bottom = slice(0, 31), slice(31, 62)
    check(tmat.shape == (62, 62), f"time matrix shape {tmat.shape}")
    block = tmat[top, bottom]
    check(bool(np.isfinite(tmat).all()) and bool((block > 0).all()),
          "top-to-bottom ray times not finite and positive")
    rest = tmat.copy()
    rest[top, bottom] = 0
    check(not rest.any(), "time matrix not zero outside the traced pairs")
    traced = np.zeros((62, 62), bool)
    traced[top, bottom] = True
    check(np.array_equal(fm.ray_len > 0, traced),
          "ray_len not positive on exactly the 961 traced pairs")
    rx, ry = fm.ray_path(0, 31)
    check((rx[0], ry[0]) == (fm.isx[0], fm.isz[0])
          and (rx[-1], ry[-1]) == (fm.isx[31], fm.isz[31]),
          "ray_path(0, 31) does not run from transducer 0 to 31")
    steps = fm.ray_len[top, bottom] - 2
    log(f"  march {counts['march']} launch for 961 rays: steps max "
        f"{int(steps.max())} mean {steps.mean():.1f}; relaxation and ray "
        f"times {counts['relax_times']} launch")
    return counts, wall, sum(builds)


def roofline(ops, nbytes):
    """The least time (ms) for this work on an H100 (SXM data sheet, 700
    W): fp32 operations over 67 TFLOP/s or bytes over 3.35 TB/s."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def walk_crossings(x1, y1, x2, y2, s, in_cross):
    """Crossings the walk scorer takes on the segments (x1, y1) -> (x2, y2)
    in fine-grid coordinates before both axes are done (``seg_walk`` in
    csrc/rays.cu): the cell boundaries round(p1) +- (k + 1/2) it crosses
    on each axis, plus the step to the end, at most ``in_cross``."""
    def axis(p1, p2):
        r = torch.round(p1)
        n = torch.where(p1 < p2, torch.floor(p2 - r - 0.5),
                        torch.floor(r - 0.5 - p2)) + 1
        return n.clamp_min(0)

    x1, y1, x2, y2 = x1 / s, y1 / s, x2 / s, y2 / s
    return (axis(x1, x2) + axis(y1, y2) + 1).clamp_max(in_cross)


def plain_march(args):
    """The twin's march (``rays.march_plain``) on ``args``, timed on the
    host clock, with the work K2 does on the same rays counted from the
    candidates the twin scores.  At each step a ray takes, the kernel
    scores the plane's first n_k of K candidates (the twin clamps the
    rest onto the last one, so they repeat it), each with its material
    samples: N for Simpson N; for the walk the crossings it takes
    (``walk_crossings``; past kWalkChunk = 8 it needs a second round).
    Returns (ms, result, work)."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    spec = args[-1]
    name = {cuda_rays.WALK: "_segment_time_walk",
            cuda_rays.SIMPSON3: "segment_time_quad3",
            cuda_rays.SIMPSON5: "segment_time_quad"}[spec.scorer]
    scorer, calls = getattr(rays, name), []

    def recording(model, mat_flat, x1, y1, x2, y2, *rest):
        calls.append((x1, y1, x2, y2))
        return scorer(model, mat_flat, x1, y1, x2, y2, *rest)

    setattr(rays, name, recording)
    try:
        ms, want = time_host(lambda: rays.march_plain(*args))
    finally:
        setattr(rays, name, scorer)
    steps = want[4]
    total = torch.zeros(5, dtype=torch.float64, device=steps.device)
    for k, (x1, y1, x2, y2) in enumerate(calls):
        live = torch.ones(x2.shape, dtype=torch.bool, device=x2.device)
        live[:, 1:] = (x2[:, 1:] != x2[:, :-1]) | (y2[:, 1:] != y2[:, :-1])
        live &= (steps > k)[:, None]
        if spec.scorer == cuda_rays.WALK:
            n = walk_crossings(x1, y1, x2, y2, spec.s, spec.in_cross)
        else:
            n = torch.full_like(x2, 3 if spec.scorer == cuda_rays.SIMPSON3
                                else 5)
        n_k = live.sum(1)
        total += torch.stack([
            (n_k > 0).sum(), n_k.sum(), (n_k - 2).clamp_min(0).sum(),
            torch.where(live, n, 0).sum(), (live & (n > 8)).sum()]).double()
    work = dict(zip(("steps", "candidates", "columns", "samples",
                     "second_round"), (int(v) for v in total.tolist())))
    check(work["steps"] == int(steps.sum()), "march work: steps miscounted")
    log(f"  march twin {ms:.1f} ms; the kernel's work: {work['steps']} "
        f"steps, {work['candidates']} candidates scored "
        f"({work['candidates'] / work['steps']:.2f} a step, K = {spec.K}), "
        f"{work['samples']} material samples "
        f"({work['samples'] / work['candidates']:.3f} a candidate); "
        f"candidates past 8 crossings: {work['second_round']}")
    return ms, want, work


def ray_bounds(model, mat_flat, ttfs, spec, work, bx, by, length,
               final_cross, waves, relax_samples=3):
    """Bounds of K2 and K3 for this run's rays.

    Bytes, each counted once and only where this run's rays go: the
    march's field cells are its steps x the 2 x ``span`` cells that the
    bilinear samples of one plane touch (``span``: the model cells along a
    plane of K candidates ``stride`` fine cells apart), at most the whole
    stack; its material rows are its steps x the cells of the fan from the
    point to the plane (``span`` / 2 for each sample a candidate takes on
    average or each plane distance, whichever is fewer); K3 reads the
    rows of the cells its polylines cross; both read the curve table,
    their per-ray vectors and polylines and write their outputs.

    Operations, counted from the twins and the march's ``work``
    (``plain_march``): each step's plane geometry, each scored
    candidate's field sample and segment set-up, each material sample,
    and n_k - 2 interior columns a step; K3 is the sum of its ``waves``
    waves (each moving vertex scores 6 segments of ``relax_samples``
    material samples) and its ray times (real segments x set-up +
    crossing intervals x one material sample)."""
    item = ttfs.element_size()
    R, P = bx.shape
    K = spec.K
    row = mat_flat.shape[1] * item
    all_rows = mat_flat.shape[0] * row
    curves = model.ray_curves.numel() * item
    n_steps = work["steps"]
    span = int((K - 1) * spec.stride / spec.s) + 2
    fan = (min(-(-work["samples"] // work["candidates"]),
               spec.plane_dist + 1) * span // 2 + 1)
    march_ops = (n_steps * OPS_PLANE + work["columns"] * OPS_COLUMN
                 + work["candidates"] * (OPS_BILINEAR + OPS_SEGMENT)
                 + work["samples"] * OPS_SAMPLE)
    march_bytes = (min(ttfs.numel(), n_steps * 2 * span) * item
                   + min(all_rows, n_steps * fan * row) + curves
                   + (4 * R + 2 * R * P) * item + 4 * R * 8)
    vidx = torch.arange(P, device=bx.device)[None, :]
    moving = 0
    for w in range(waves):
        moving += int(((vidx % 2 == (1 + w) % 2) & (vidx >= 1)
                       & (vidx <= P - 2) & (vidx < (length - 1)[:, None])
                       ).sum())
    real = (vidx[:, :-1] + 1) < length[:, None]
    cross = ((bx[:, 1:] - bx[:, :-1]).abs()
             + (by[:, 1:] - by[:, :-1]).abs()) / spec.s + 1
    crossed_rows = min(all_rows, int(cross[real].sum()) * row)
    intervals = float(cross.clamp_max(2 * final_cross + 1)[real].sum())
    k3_ops = (moving * (6 * (OPS_SEGMENT + relax_samples * OPS_SAMPLE) + 40)
              + int(real.sum()) * OPS_SEGMENT + intervals * OPS_SAMPLE)
    k3_bytes = (crossed_rows + curves + (2 * R * P * (2 if waves else 1)
                                         + R) * item + R * 8)
    log(f"  bounds: march {n_steps} steps, {2 * span} field cells and {fan} "
        f"material rows a step, {march_bytes / 1e6:.2f} MB and "
        f"{march_ops / 1e9:.3f} Gop; K3 {waves} waves ({moving} vertex "
        f"moves) and the times, {k3_bytes / 1e6:.2f} MB and "
        f"{k3_ops / 1e9:.4f} Gop")
    return dict(march=roofline(march_ops, march_bytes),
                relax_times=roofline(k3_ops, k3_bytes))


def time_events(fn, n=10):
    """Warm time per call (ms) of ``fn``: CUDA events over n calls."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def time_host(fn):
    """One call of ``fn`` on the host clock, synchronised: (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def time_march(args, n):
    """K2 on ``args`` (float32), warm: the bare launch with its outputs
    allocated beforehand and the call through its wrapper (CUDA events
    over n calls), the longest ray's steps, the step split by part (the
    clock64 build, on the longest ray), the blocks resident per SM and a
    march of every 8th ray."""
    from alifmm_tpu_torch.ops import cuda_rays

    p = cuda_rays.prepare_march(*args)
    bare = time_events(p.run, n)
    wrapper = time_events(lambda: cuda_rays.march(*args), n)
    steps = p.out[4]
    chain = int(steps.max())
    pp = cuda_rays.prepare_march(*args, profile=True)
    pp.run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(pp.out[:5], p.out)),
          "the march's profiling build marched otherwise")
    cyc = pp.out[5][int(torch.argmax(steps))].double()
    split = dict(zip(("scoring", "reduction", "rest"),
                     (cyc / cyc.sum()).tolist()))
    warps = cuda_rays.occupancy(p, args[-1].scorer, torch.float32) * 4
    us = bare * 1e3 / chain
    # the same march over every 8th ray, fewer than one block an SM: what
    # a step takes when its warps do not share the SM's issue slots
    few = [a[::8].contiguous() for a in args[3:6]]
    pf = cuda_rays.prepare_march(*args[:3], *few, args[-1])
    us_alone = time_events(pf.run, n) * 1e3 / int(pf.out[4].max())
    log(f"  K2 {bare:.4f} ms bare, {wrapper:.4f} ms through the wrapper, for "
        f"{args[3].shape[0]} rays (K = {args[-1].K}, {p.plan['lanes']} lanes "
        f"a ray, curves in {'shared' if p.plan['curves_smem'] else 'device'}"
        f" memory, {p.plan['smem']} B); the longest ray takes {chain} "
        f"dependent steps: {us:.3f} us a step, of which scoring "
        f"{split['scoring']:.3f}, reduction {split['reduction']:.3f}, the "
        f"rest {split['rest']:.3f} (clock64 on that ray: "
        f"{us * split['scoring']:.3f} / {us * split['reduction']:.3f} / "
        f"{us * split['rest']:.3f} us); all rays {int(steps.sum())} steps; "
        f"{warps} warps resident per SM; every 8th ray alone: "
        f"{us_alone:.3f} us a step")
    return dict(ms=bare, wrapper_ms=wrapper, chain=chain, us_per_step=us,
                us_per_step_few_rays=us_alone, step_split=split,
                lanes=p.plan["lanes"], warps_per_sm=warps,
                steps=int(steps.sum()))


def time_k3(model, mat_flat, bx, by, length, s, kw, n=10):
    """K3 on these polylines (float32), warm: the bare launch and the call
    through its wrapper (CUDA events over n calls), the composed twin's
    time and the blocks resident per SM."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    args = (model, mat_flat, bx, by, length, s)
    p = cuda_rays.prepare_relax_and_times(*args, **kw)
    bare = time_events(p.run, n)
    wrapper = time_events(lambda: cuda_rays.relax_and_times(*args, **kw), n)
    twin = time_host(lambda: rays.relax_and_times_plain(*args, **kw))[0]
    warps = cuda_rays.occupancy(p, cuda_rays._quad_scorer(kw["quad"]),
                                torch.float32) * 4
    log(f"  K3 ({kw['waves']} waves, then the times; P = {bx.shape[1]}; "
        f"polyline in {'shared' if p.plan['poly_smem'] else 'device'} "
        f"memory, {p.plan['smem']} B): {bare:.4f} ms bare, {wrapper:.4f} ms "
        f"through the wrapper; plain twin {twin:.2f} ms; {warps} warps "
        f"resident per SM")
    return dict(ms=bare, wrapper_ms=wrapper, plain_ms=twin,
                warps_per_sm=warps)


def with_bound(timed, bound):
    b, by_what = bound
    timed.update(bound_ms=b, bound_by=by_what, share=b / timed["ms"])
    log(f"    bound {b:.5f} ms ({by_what}), share of the bare time "
        f"{b / timed['ms']:.4f}; library call: none ({NO_LIBRARY})")
    return timed


def phase_ray_kernels_weld(inputs, ttfs, worst, device):
    """The ray kernels at the weld shape (961 rays through the 31 fields
    just solved): against their twins in float32 and float64 (the largest
    differences go into ``worst``), and timed warm beside their bounds
    and their twins, with the weld's knobs and the facade's defaults."""
    from alifmm_tpu_torch import weld_data

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = (inputs[0] if dtype == torch.float32
                 else ray_model("weld", dtype, device))
        fields = ttfs.to(dtype)
        mat_flat, tidx, src, rec, spec, final_cross = march_inputs(
            model, *MARCH_KNOBS["weld knobs"], sx, sy, pairs, dnx)
        args = (model, mat_flat, fields, tidx, src, rec, spec)
        ms_twin, want, work = plain_march(args)
        what = f"weld {str(dtype).replace('torch.', '')}"
        merge_worst(worst, march_vs_twin(args, want, final_cross, dtype,
                                         what))
        merge_worst(worst, check_k3(model, mat_flat, *want[:3], spec.s,
                                    final_cross, dtype, what))
        if dtype != torch.float32:
            continue
        log(f"  curve table {tuple(model.ray_curves.shape)} "
            f"({model.ray_curves.numel() * 4} B in float32)")
        k2 = time_march(args, 10)
        k2["plain_ms"] = ms_twin
        bx, by, length = want[:3]
        waves = 2 * RAY_OPTS["relax_iters"]
        bounds = ray_bounds(model, mat_flat, fields, spec, work, bx, by,
                            length, final_cross, waves)
        out["march"] = with_bound(k2, bounds["march"])
        kw = dict(waves=waves, relax_cross=final_cross,
                  quad=RAY_OPTS["relax_quad"], times_cross=final_cross)
        out["relax_times"] = with_bound(
            time_k3(model, mat_flat, bx, by, length, spec.s, kw),
            bounds["relax_times"])
    out["facade defaults"] = check_default_march(inputs[0], ttfs, worst,
                                                 (sx, sy, pairs, dnx))
    return out


def check_default_march(model, ttfs, worst, geometry):
    """The facade's default knobs (crossing-walk scorer, one model cell per
    step, 57 candidates, 9 fine cells per model cell) at the weld shape,
    float32: K2 against its twin and timed beside its bound; K3 with no
    waves (the facade's default) timed beside its bound; and K3 with one
    wave pair against its twin on these long polylines in float32 and
    float64 (whose polyline needs the shared-memory opt-in).  The
    differences go into ``worst``."""
    from alifmm_tpu_torch import rays

    mat_flat, tidx, src, rec, spec, final_cross = march_inputs(
        model, dict(), 9, *geometry)
    args = (model, mat_flat, ttfs, tidx, src, rec, spec)
    t_plain, want, work = plain_march(args)
    merge_worst(worst, march_vs_twin(args, want, final_cross, torch.float32,
                                     "weld, facade defaults, float32"))
    k2 = time_march(args, 3)
    k2["plain_ms"] = t_plain
    bx, by, length = want[:3]
    bounds = ray_bounds(model, mat_flat, ttfs, spec, work, bx, by, length,
                        final_cross, 0)
    kw = dict(waves=0, relax_cross=final_cross, quad=True,
              times_cross=final_cross)
    k3 = time_k3(model, mat_flat, bx, by, length, spec.s, kw)
    model64 = ray_model("weld", torch.float64, model.device)
    for m, dt in ((model, torch.float32), (model64, torch.float64)):
        merge_worst(worst, check_k3(
            m, rays._material_flat(m), bx.to(dt), by.to(dt), length,
            spec.s, final_cross, dt,
            f"weld, facade defaults' polylines, {str(dt)[6:]}", iters=(1,),
            scorers=K3_SCORERS[:1], single_waves=False))
    return dict(march=with_bound(k2, bounds["march"]),
                relax_times=with_bound(k3, bounds["relax_times"]))


def stage_inputs(inputs):
    """Each stage's K1 input in the weld solve, as solver._stage_first,
    _stage_next and _stage_final build them: (name, model, field, fixed)."""
    from alifmm_tpu_torch import solver

    model, scx, scz = inputs[:3]
    cfg = solver.SolveConfig(**SOLVE_KW)
    isz, isx = solver._source_cells(model, scx, scz)
    out = []
    tt = bz = bx = None
    for k, (half, factor) in enumerate(solver.coarse_stages(cfg)):
        hz, hx, nbz, nbx = solver._window(model, isz, isx, half)
        patches = solver._slice_model(model, nbz, nbx, hz, hx, factor)
        if k == 0:
            t0, fixed = solver._analytic_seed(
                patches, model, isz, isx, (isz - nbz) * factor,
                (isx - nbx) * factor, solver._COARSE_SEED_SIDE,
                solver._COARSE_SEED_SIGN)
        else:
            t0, fixed = solver._inject(tt, bz, bx, 3 * factor, patches.shape,
                                       nbz, nbx, factor, model.shape)
        Z, X = patches.shape
        out.append((f"s{k + 1} patches {Z}x{X}", patches, t0, fixed))
        tt, _ = solver._patch_solve(t0, patches, fixed, cfg)
        bz, bx = nbz, nbx
    zero = torch.zeros_like(bz)
    t0, fixed = solver._inject(tt, bz, bx, 3, model.shape, zero, zero, 1,
                               model.shape)
    Z, X = model.shape
    out.append((f"s4 final {Z}x{X}", model, t0, fixed))
    return out


def bound_ms(tt, fixed, packed):
    """The least time one pass could take on an H100 (SXM data sheet, 700
    W): the larger of its fp32 operations over 67 TFLOP/s and its bytes
    over 3.35 TB/s.  Operations: 4 sweeps x the points that are not fixed
    x OPS_PER_UPDATE; bytes: the field read and written once, the fixed
    mask and the 12 material planes read once."""
    n_upd = 4 * int((~fixed).sum())
    ops = n_upd * OPS_PER_UPDATE
    item = tt.element_size()
    nbytes = (2 * tt.numel() * item + fixed.numel()
              + packed.planes.numel() * item)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_k1(tt, fixed, packed, cluster=None, lanes=None, n=10):
    """Warm K1 time per pass (ms), CUDA events over n launches."""
    from alifmm_tpu_torch.ops import cuda_sweep

    B = tt.shape[0]
    rep, act = np.zeros(B, bool), np.ones(B, bool)
    out, _, _ = cuda_sweep._launch(tt, fixed, packed, rep, act, cluster, lanes)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        cuda_sweep._launch(tt, fixed, packed, rep, act, cluster, lanes)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, out


def phase_pass_timing(inputs):
    """K1 warm at every stage shape of the weld solve (float32), beside its
    bound; launch shapes compared at each; one plain pass at the final
    shape."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    shapes = []
    for name, model, tt0, fixed in stage_inputs(inputs):
        packed = cuda_sweep.pack_model(model)
        B, Z, X = tt0.shape
        C, G = cuda_sweep.launch_config(B, Z, X, cuda_sweep._sm_count(
            tt0.device))
        ms, out_k = time_k1(tt0, fixed, packed)
        bound, by = bound_ms(tt0, fixed, packed)
        log(f"  {name} ({B} sources) K1 {ms:.4f} ms per pass at C={C} G={G}; "
            f"bound {bound:.4f} ms ({by}), share {bound / ms:.4f}")
        alt = []
        for c in cuda_sweep.CLUSTER_SIZES:
            for g in cuda_sweep.LANE_COUNTS:
                if -(-max(Z, X) // c) < 2:
                    continue
                t, _ = time_k1(tt0, fixed, packed, c, g, n=3)
                alt.append(f"C={c} G={g} {t:.4f}")
        log(f"    launch shapes (ms per pass): {'; '.join(alt)}")
        shapes.append(dict(stage=name, sources=B, cluster=C, lanes=G, ms=ms,
                           bound_ms=bound, bound_by=by))
    t0 = time.perf_counter()
    out_p = sweep.gs_pass(tt0, model, fixed, replace=False)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    abs_e, rel_e = rel_err(out_k, out_p)
    log(f"  {name} plain twin {ms_p:.1f} ms per pass; K1 against it: max "
        f"abs {abs_e:.3e} max rel {rel_e:.3e}")
    check(rel_e <= TOL_PASS[torch.float32], "final-shape pass differs")
    return shapes, ms_p, abs_e


SCORER_NAMES = {0: "simpson3", 1: "simpson5", 2: "walk", 3: "exact"}


def ptxas_summary(report):
    """{kernel: (registers, spill bytes)} from ``-Xptxas -v`` output; ray
    kernels by name, type and scorer (``march_kernel<f,walk,0>``: float,
    the walk, no profiling), others by their mangled name."""
    out, name, spill = {}, None, 0
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), 0
            k = re.search(r"([a-z_]+_kernel)I([fd])((?:L[ib]\d+E)*)E", name)
            if k:
                ints = [int(v) for v in
                        re.findall(r"L[ib](\d+)E", k.group(3))]
                if ints and k.group(1) in ("march_kernel",
                                           "relax_times_kernel"):
                    ints[0] = SCORER_NAMES[ints[0]]
                args = ",".join([k.group(2)] + [str(i) for i in ints])
                name = f"{k.group(1)}<{args}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def build_kernels():
    """Compile every kernel source, one nvcc per source, all at once;
    returns ptxas' registers and spills by kernel."""
    from alifmm_tpu_torch.ops import cuda_rays, cuda_sweep

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(mod.build, verbose=True)
                for mod in (cuda_sweep, cuda_rays)]
        for job in jobs:
            job.result()
    log(f"[2] K1 (sweep.cu) and K2, K3 (rays.cu) built in "
        f"{time.perf_counter() - t0:.2f} s")
    regs = {}
    for mod in (cuda_sweep, cuda_rays):
        regs.update(ptxas_summary(mod.BUILD_LOG))
    for name, (n, spill) in regs.items():
        log(f"    ptxas: {name[:120]}: {n} registers, {spill} bytes of "
            f"spill")
    return regs


def ray_kernel_entry(name, replaces, launches, errs, timed, defaults, regs,
                     stem):
    """One ray kernel's object in the kernels line: the weld knobs' bare
    time as ``ms``, the facade defaults' figures beside it."""
    entry = {
        "name": name, "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/rays.cu", "replaces": replaces,
        "launches": launches, **errs,
        **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: v for k, v in timed.items()
           if k not in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "facade_defaults": defaults,
        "registers_f32": {k: v[0] for k, v in regs.items()
                          if k.startswith(stem + "<f")},
        "spill_bytes_f32": max([v[1] for k, v in regs.items()
                                if k.startswith(stem + "<f")] or [0]),
    }
    return entry


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import alifmm_tpu_torch  # noqa: F401  (the port must sit beside this file)

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] device {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    regs = build_kernels()

    log("[3] K1 against its plain twin")
    worst = phase_kernel_vs_plain(device)
    log("[4] ray kernels (K2, K3) against their plain twins")
    ray_worst = phase_rays_vs_plain(device)
    log("[5] analytic check at full size")
    phase_analytic(device)
    log("[6] weld slice (31 fields, 961 rays, float32): direct path, then "
        "through the facade")
    inputs, ttfs, (wall, t_solve, t_rays) = phase_slice(device)
    counts, facade_wall, t_builds = phase_facade(device)
    log(f"  weld slice warm wall clock: facade {facade_wall:.4f} s (its two "
        f"model builds {t_builds:.4f} s, the rest "
        f"{facade_wall - t_builds:.4f} s); direct {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s)")
    log("[7] ray kernels at the weld shape: against their twins, and timed "
        "beside their bounds")
    weld = phase_ray_kernels_weld(inputs, ttfs, ray_worst, device)
    log("[8] K1 warm at every stage shape, beside its bound; one plain pass "
        "at the final shape")
    shapes, ms_p, abs_e = phase_pass_timing(inputs)
    final = shapes[-1]

    check("jax" not in sys.modules, "jax was imported")
    kernels = [{
        "name": "K1 sweep pass",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep.cu",
        "replaces": "alifmm_tpu/ops/pallas_sweep.py:124",
        "launches": counts["sweep_pass"],
        "max_abs_err": max(worst, abs_e),
        "ms": final["ms"],
        "plain_ms": ms_p,
        "bound_ms": final["bound_ms"],
        "bound_by": final["bound_by"],
        "library_ms": None,
        "cluster": final["cluster"],
        "lanes": final["lanes"],
        "shapes": shapes,
    }]
    defaults = weld["facade defaults"]
    kernels.append(ray_kernel_entry(
        "K2 ray march", "alifmm_tpu/rays.py:728", counts["march"],
        dict(max_abs_err=ray_worst["march"],
             rays_equal_share=1.0 - ray_worst["march_unequal"]),
        weld["march"], defaults["march"], regs, "march_kernel"))
    kernels.append(ray_kernel_entry(
        "K3 relaxation waves and ray times", "alifmm_tpu/rays.py:445",
        counts["relax_times"],
        dict(max_abs_err=ray_worst["relax_vertices"],
             max_abs_err_times=ray_worst["relax_times"],
             max_rel_err_times=ray_worst["relax_times_rel"],
             also_replaces="alifmm_tpu/rays.py:333"),
        weld["relax_times"], defaults["relax_times"], regs,
        "relax_times_kernel"))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
