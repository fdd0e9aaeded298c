"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no fallback to the CPU):

1. device check: a CUDA device must be present; prints nvidia-smi's name
   and power limit;
2. builds the sweep kernel K1 from ``alifmm_tpu_torch/csrc`` with nvcc;
3. holds K1 against its plain PyTorch twin on the card: one pass and a
   full fixpoint on a 48 x 56 model (three sources) in float64 and
   float32, and one pass on per-source 109 x 109 patch materials;
4. analytic check at full size: homogeneous isotropic 424 x 500, one
   interior source, relative error against r / v;
5. the weld slice at full size in float32: 31 receiver fields through the
   telescoped solver, then 961 rays; a warm-up run, then one timed run
   with every launch count set to 0 just before it;
6. one K1 pass against one plain pass at the final-stage shape
   (31 x 424 x 500, float32), both timed, outputs compared.

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


def small_model(dtype, device):
    """The 48 x 56 weld-like problem of __graft_entry__._small_problem."""
    from alifmm_tpu_torch import grid

    Z, X = 48, 56
    rng = np.random.default_rng(0)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.ones((Z, X), dtype=int)
    velpn[12:36, 16:40] = 0
    vel_map = np.where(velpn == 1, 5790.0, 1.0)
    stif = np.zeros((Z, X, 5))
    stif[:, :] = [263000, 148000, 216000, 129000, 8100]
    return grid.make_model(veln, velpn, vel_map, stif, None, None, 2e-4,
                           dtype=dtype, device=device)


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


def check_pass(model, tt, fixed, replace, dtype, what):
    """One K1 pass against one plain pass on the same inputs."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    new_k, dk, sk = cuda_sweep.sweep_pass(tt, model, fixed, replace)
    new_p = sweep.gs_pass(tt, model, fixed, replace=replace)
    dp, sp = sweep.delta_scale(new_p, tt)
    abs_e, rel_e = rel_err(new_k, new_p)
    log(f"  {what}: max abs {abs_e:.3e} max rel {rel_e:.3e} "
        f"(tolerance {TOL_PASS[dtype]:.0e})")
    check(rel_e <= TOL_PASS[dtype], f"{what}: kernel differs from plain twin")
    np.testing.assert_allclose(dk, dp.cpu().numpy(), rtol=TOL_PASS[dtype])
    np.testing.assert_allclose(sk, sp.cpu().numpy(), rtol=TOL_PASS[dtype])
    return new_p, abs_e


def phase_kernel_vs_plain(device):
    from alifmm_tpu_torch import grid, solver, weld_data
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        model = small_model(dtype, device)
        tt, fixed = seeded(model.shape, 3, dtype, device)
        name = str(dtype).replace("torch.", "")
        mid, e = check_pass(model, tt, fixed, False, dtype, f"gs_pass min {name}")
        worst = max(worst, e)
        _, e = check_pass(model, mid, fixed, True, dtype,
                          f"gs_pass replace {name}")
        worst = max(worst, e)
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

    # per-source patch materials: 109 x 109 windows at 27x refinement
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
    model = grid.make_model(veln, velpn, vel_map, stif, None, None,
                            weld_data.DNX, dtype=torch.float64, device=device)
    scx = torch.tensor([100.0, 250.0, 400.0], dtype=torch.float64,
                       device=device) * weld_data.DNX
    scz = torch.tensor([423.0, 423.0, 200.0], dtype=torch.float64,
                       device=device) * weld_data.DNX
    isz, isx = solver._source_cells(model, scx, scz)
    hz, hx, bz, bx = solver._window(model, isz, isx, 2)
    patches = solver._slice_model(model, bz, bx, hz, hx, 27)
    check(patches.shape == (109, 109), f"patch shape {patches.shape}")
    tt, fixed = solver._analytic_seed(patches, model, isz, isx,
                                      (isz - bz) * 27, (isx - bx) * 27, 13,
                                      -1.0)
    _, e = check_pass(patches, tt, fixed, False, torch.float64,
                      "gs_pass on per-source 109x109 patches float64")
    return max(worst, e)


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


def phase_pass_timing(inputs):
    from alifmm_tpu_torch import solver
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    model, scx, scz, _, _, _ = inputs
    cfg = solver.SolveConfig(**SOLVE_KW)
    (h0, f0), (h1, f1), (h2, f2) = solver.coarse_stages(cfg)
    tt, bz, bx, _ = solver._stage_first(model, scx, scz, h0, f0, 13, -1.0, cfg)
    tt, bz, bx, _ = solver._stage_next(model, scx, scz, tt, bz, bx, h1, f1, cfg)
    tt, bz, bx, _ = solver._stage_next(model, scx, scz, tt, bz, bx, h2, f2, cfg)
    zero = torch.zeros_like(bz)
    tt0, fixed = solver._inject(tt, bz, bx, 3, model.shape, zero, zero, 1,
                                model.shape)
    B = tt0.shape[0]
    packed = cuda_sweep.pack_model(model)
    rep = np.zeros(B, bool)
    act = np.ones(B, bool)
    out_k, _, _ = cuda_sweep._launch(tt0, fixed, packed, rep, act)  # warm
    n = 5
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        out_k, _, _ = cuda_sweep._launch(tt0, fixed, packed, rep, act)
    e1.record()
    torch.cuda.synchronize()
    ms_k = e0.elapsed_time(e1) / n
    t0 = time.perf_counter()
    out_p = sweep.gs_pass(tt0, model, fixed, replace=False)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    abs_e, rel_e = rel_err(out_k, out_p)
    log(f"  one pass at 31x424x500 float32: K1 {ms_k:.3f} ms, plain twin "
        f"{ms_p:.1f} ms; max abs {abs_e:.3e} max rel {rel_e:.3e}")
    check(rel_e <= TOL_PASS[torch.float32], "final-shape pass differs")
    return ms_k, ms_p, abs_e


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
    log("[6] one pass, K1 against the plain twin, at the final-stage shape")
    ms_k, ms_p, abs_e = phase_pass_timing(inputs)

    check("jax" not in sys.modules, "jax was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 sweep pass",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep.cu",
        "replaces": "alifmm_tpu/ops/pallas_sweep.py:124",
        "launches": launches,
        "max_abs_err": max(worst, abs_e),
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
