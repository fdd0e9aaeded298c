"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no fallback to the CPU):

1. device check: a CUDA device must be present; prints nvidia-smi's name
   and power limit;
2. builds the sweep kernel K1 from ``alifmm_tpu_torch/csrc`` with nvcc;
3. holds K1 against its plain PyTorch twin on the card, in float64 and
   float32: a min pass and a replace pass on each case of ``PASS_CASES``
   (48 x 56, per-source weld patches of 109 x 109 and 79 x 79, narrow
   5 x 7 and 37 x 131 with ragged and empty width tiles, a tie-heavy
   isotropic 64 x 64) at several launch shapes, and a full fixpoint on
   48 x 56 (equal pass counts in float64);
4. analytic check at full size: homogeneous isotropic 424 x 500, one
   interior source, relative error against r / v;
5. the weld slice at full size in float32: 31 receiver fields through the
   telescoped solver, then 961 rays; a warm-up run, then one timed run
   with every launch count set to 0 just before it;
6. K1 timed warm (CUDA events) on each stage's input of the weld solve
   (31 x 109 x 109 twice, 31 x 79 x 79, 31 x 424 x 500; float32) beside
   its bound, at its own launch shape and at every other one; one plain
   pass at the final shape, timed and compared.

The last lines are the card line, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def phase_slice(device):
    from alifmm_tpu_torch.ops import cuda_sweep, sweep
    from alifmm_tpu_torch.ops.stencils import INF

    inputs = weld_inputs(device)
    t0 = time.perf_counter()
    run_slice(inputs)
    log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    cuda_sweep.LAUNCHES = 0
    sweep.CALLS = 0
    ttfs, info, out, (t_solve, t_rays, wall) = run_slice(inputs, rec)
    launches, plain_calls = cuda_sweep.LAUNCHES, sweep.CALLS
    bx, by, lengths, times, reason = out
    log(f"  weld slice warm wall clock {wall:.4f} s (solve {t_solve:.4f} s, "
        f"rays {t_rays:.4f} s)")
    for name, sec in stages:
        log(f"    stage [{name}] {sec:.4f} s")
    log(f"  final stage passes {info.passes} converged {info.converged}")
    log(f"  K1 launches {launches}, plain twin passes {plain_calls}")
    reasons = {int(k): int(v) for k, v in
               zip(*np.unique(reason.cpu().numpy(), return_counts=True))}
    log(f"  rays by reason (0 arrived, 1 plane left grid, 2 truncated): "
        f"{reasons}")
    check(launches > 0, "the main path launched no K1")
    check(plain_calls == 0, "the main path ran the plain twin on the card")
    check(ttfs.shape == (31, 424, 500), f"field shape {tuple(ttfs.shape)}")
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          "weld fields not finite everywhere")
    check(times.shape == (961,), f"times shape {tuple(times.shape)}")
    check(bool(torch.isfinite(times).all()) and bool((times > 0).all()),
          "ray times not finite and positive")
    return inputs, launches, wall, stages


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

    from alifmm_tpu_torch.ops import cuda_sweep

    t0 = time.perf_counter()
    cuda_sweep.build(verbose=True)
    log(f"[2] K1 built in {time.perf_counter() - t0:.2f} s")
    for ln in cuda_sweep.BUILD_LOG.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"    ptxas: {ln.strip()}")

    log("[3] K1 against its plain twin")
    worst = phase_kernel_vs_plain(device)
    log("[4] analytic check at full size")
    phase_analytic(device)
    log("[5] weld slice (31 fields, 961 rays, float32)")
    inputs, launches, wall, _ = phase_slice(device)
    log("[6] K1 warm at every stage shape, beside its bound; one plain pass "
        "at the final shape")
    shapes, ms_p, abs_e = phase_pass_timing(inputs)
    final = shapes[-1]

    check("jax" not in sys.modules, "jax was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 sweep pass",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep.cu",
        "replaces": "alifmm_tpu/ops/pallas_sweep.py:124",
        "launches": launches,
        "max_abs_err": max(worst, abs_e),
        "ms": final["ms"],
        "plain_ms": ms_p,
        "bound_ms": final["bound_ms"],
        "bound_by": final["bound_by"],
        "library_ms": None,
        "cluster": final["cluster"],
        "lanes": final["lanes"],
        "shapes": shapes,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
