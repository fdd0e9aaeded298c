"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no fallback to the CPU):

1. device check: a CUDA device must be present; prints nvidia-smi's name
   and power limit;
2. builds the kernels from ``alifmm_tpu_torch/csrc`` with nvcc, one
   compiler per source, all at once: the sweep kernel K1 and the slab
   sweep K5 (``sweep.cu``), K1's other forms (``sweep_forms.cu``),
   the ray kernels K2 and K3 (``rays.cu``), the descent march K4
   (``descent.cu``) and the model build's planes K6 (``planes.cu``);
   prints ptxas' registers and spills per kernel;
3. holds K1 against its plain PyTorch twin on the card, in float64 and
   float32: a min pass and a replace pass on each case of ``PASS_CASES``
   (48 x 56, per-source weld patches of 109 x 109 and 79 x 79, narrow
   5 x 7 and 37 x 131 with ragged and empty width tiles, a tie-heavy
   isotropic 64 x 64) at several launch shapes, and a full fixpoint on
   48 x 56 (equal pass counts in float64).  The eager twin is bound by
   the host's per-operation cost, so this phase runs in a second process
   (``chip_smoke.py --k1-twin``, in inference mode, with phase 14a's
   float64 half), started as soon as ``sweep.cu`` and ``sweep_forms.cu``
   are built: beside the other sources' compilation and the checks that
   time nothing (4, 4b, 4c, 5b, 11a, 12a and 14a's float32 half), which
   run first for that reason; its log is printed when it ends, before
   phase 5;
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
4b. the ray kernels' fine-path instantiations against their twins on
   48 x 56, float64 and float32 (``phase_fine_rays_vs_plain``): the
   segment integrators on stiffness rows (the per-sample Christoffel
   solve), and K2 with the nearest-point tap on fields solved on the
   refined grid (s = 3), with exact materials, with both, and with
   ``fast_step_scale`` on a model uniform away from a slow band, each
   followed by K3 on the marched polylines where the rows are exact;
4c. K4 against its plain twin ``descent_plain`` on 48 x 56, float64 and
   float32, with the facade's descent defaults and with score_k 5, on
   fields of the model grid and of the refined grid and on a model whose
   slow band bends the rays (``DESCENT_CASES``), as bare launches (the
   tables in shared and in device memory; every step exact) and through
   the wrapper ``cuda_rays.march_descent``, equal ray for ray; then
   ``trace_rays_descent`` (one K4 and one K3 launch) against K3's twin on
   K4's polylines; in float32 the share of steps K4's profiling build ran
   again exactly (``check_descent``);
5. analytic checks: homogeneous isotropic 424 x 500, one interior source,
   relative error against r / v with the default budget and with
   ``SolveConfig.accuracy()``; then tests/test_analytic_truth.py's
   accuracy-preset cases at their own sizes in float64 (isotropic v =
   3000 and homogeneous qP at veln 30, N = 41 and 81) within that file's
   bounds;
5b. K1 against its plain twin at the fine path's patch shapes (four
   weld sources, 397 x 397 at 9x and 295 x 295 at 3x, float64 and
   float32, one min pass at both lane counts);
5c. the same isotropic model solved with ``subgrid_size=9`` (3808 x
   4492) against r / v on the refined grid;
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
7b. K4 at the weld shape (961 rays through the fields of phase 6), the
   facade's descent defaults and score_k 5: against its twin in float64
   and float32 as in 4c, and timed warm in float32 beside its bound
   (from the steps the twin took) and the twin's time, with the SM clock,
   the warps resident per SM, the longest ray's step split by part and
   the shares of steps and window pieces run again exactly (clock64, the
   float32 build that only the checks launch; likewise wherever K4 is
   timed);
7c. the FMC slice (every pair of the 62 transducers: 61 fields of 424 x
   500, 1891 rays, float32) with each tracer (search, descent, auto):
   directly (``solve_ttf``, then the tracer with the knobs the facade
   routes to it) and through ``ALI_FMM``, a warm-up run then a timed one
   with every count set to 0 just before it; every ray arrives with a
   finite positive time, no auto time is above its descent time, the
   launch counts are the tracer's (auto: one K4 and one K3, and one K2
   and one K3 for all the rays it retraces), the facade's times equal the
   direct path's; auto's ray phase beside the descent's; the descent and
   auto times against the search times; K4 timed on the FMC fields;
7d. one ``utils/profiling.trace`` each of a warm weld slice and a warm FMC
   slice with the descent tracer: the device's busy share from the
   Chrome trace;
8. K1 timed warm (CUDA events) on each stage's input of the weld solve
   (31 x 109 x 109 twice, 31 x 79 x 79, 31 x 424 x 500; float32) beside
   its bound, at its own launch shape and at every other one; one plain
   pass at the final shape (the graphed twin, ``sweep.gs_pass(graphed=
   True)``), timed and compared;
9. the fine weld slice in float32 (s = 9: 31 fields of 3808 x 4492, 961
   rays): the direct path (``solve_ttf(subgrid_size=9)`` +
   ``trace_rays(mode="grid")``; a warm-up run, then a timed one with
   every count set to 0 just before it, its stage split, passes,
   launches and peak device memory, and its ray times against the
   interp-mode times of phase 6), the ray phase again with exact
   materials, then ``ALI_FMM(ttf_mode="grid")
   .find_all_TTF_rays_parallel(subgrid_size=9)``, timed with the counts
   set to 0 just before it;
10. K1 timed warm at the three stage shapes of the fine solve beside its
   bound; K2 with the nearest-point tap, and with exact materials too, on
   the fine fields against its twin (float32) and timed beside its bound
   and the twin; K3 with exact materials likewise;
10b. K4 in grid mode on the fine fields (score_k 0 and 5): against its
   twin in float32 (timed) and float64;
11. shear modes (qSV tables from ``materials.generate_mode_curves``, an
   interpolated table column: K1's column mode 2): (11a) K1 against its
   graphed twin, max abs 0, float64 and float32, a min and a replace pass
   at the AUTO launch shapes on ``QSV_PASS_CASES`` (48 x 56 with a qSV
   block, the qSV weld's patches at 109 x 109 and 79 x 79), and the
   fixpoint under ``for_mode("qsv")``'s final-stage budget on 48 x 56 in
   float64 (equal pass counts); (11b) tests/test_qsv_mode.py's
   homogeneous 33 x 37 cases in float64 within that file's bounds; (11c)
   the qSV weld slice (the seeded weld with a qSV column in the weld and a
   3240 m/s isotropic parent, 31 fields, 961 rays, float32,
   ``for_mode("qsv")``): directly, then through ``ALI_FMM`` with the
   weld's knobs and with the auto tracer's defaults, each a warm-up run
   and a timed one with every count set to 0 just before it; converged
   in fewer than 96 passes, the facade's times equal to the direct
   path's, every qSV ray time 1.5-2.8 times its qP time of phase 6, the
   plane search's rays arrived or finished at the grid's edge near their
   receiver, every auto ray arrived unless neither the descent nor the
   search lands it (as in the JAX package); K4 against its twin on the qSV
   fields; (11d) K1 timed warm at the qSV weld's final shape beside the
   qP weld's time and its bound;
12. the sharded solves (``parallel/shard``, ``parallel/multihost``) on
   meshes of virtual ranks of the one card (four z slabs, 2 x 2 z and x
   blocks, three z slabs, four source ranks): (12a) the slab sweep kernel
   K5 against its graphed twin ``sweep.slab_sweep``, max abs 0, float64
   and float32, on ``HALO_CASES`` (48 x 56 on four slabs and on 2 x 2
   blocks, both with padded rows or columns, and both on a qSV model whose
   interpolated table column is K5's column mode 2), in ``slab_config``'s
   layouts and in forced ones (four slabs with c = 1 and G = 4, 2 x 2
   with c = 3: ragged tiles, the per-line schedule on both): every
   directional sweep of a halo pass as a bare launch, min and replace, a
   pass through ``_halo_jacobi_block`` or ``_halo_block2d``, and a sweep
   through the wrapper ``cuda_sweep.slab_sweep``; (12b)
   ``solve_halo_sharded`` with a
   fixed budget against K1's single-device ``solve_fixpoint`` with the
   matched budget, max abs 0, on 48 x 56 and qSV 48 x 56 (four slabs, 2 x
   2) and 50 x 56 (three slabs, a padded row) in both types, and on the
   weld's final
   stage (the injected state of its 31 sources at 424 x 500, float32) on
   four slabs and 2 x 2; (12c) ``solve_ttf_halo`` on the weld (its
   budgets, residual-driven) on four slabs and 2 x 2 against the
   single-device solve, with 50 and 40 K5 launches, then K5 at the
   weld's final shape: one slab z-sweep against its twin and timed beside
   its bound, the refreshed x-sweep of the four slabs in one launch
   against its twin and timed beside its bound and beside the per-line
   schedule (and one of its one-line launches), a halo round of each
   layout beside K1's pass and its bound, with 10 and 8 K5 launches, the
   exchange copies and bytes a round; (12d)
   ``solve_ttf_sharded`` and ``trace_rays_sharded`` on four source ranks
   against the unsharded weld slice bit for bit, directly and in a
   one-rank NCCL group (``multihost.init`` on tcp://localhost, left at
   the end); (12e) the weld slice through ``ALI_FMM(grid_mesh=...)`` (four
   z slabs), a warm-up call and a timed one with every count set to 0
   just before it (K1, 50 K5, one K2 and one K3 launch, no plain pass),
   its ray times and fields against the plain facade's;
13. the tutorial notebook's workload (``examples/tutorial_torch.ipynb``,
   its cells in code, the plots left out) through ``ALI_FMM`` on the card
   at its own sizes (201 x 201, dnx = 1e-3, three transducers on the top
   edge, rays at ``subgrid_size=9``, float32), each call a warm-up and a
   timed run with every count set to 0 just before it: (13a) the
   velocity-gradient field against the analytic time, within the JAX
   package's own error on that model (``tests/tutorial_records.py``) plus
   a float32 margin; (13b) the ``sources`` mask: the masked field zero,
   the others within the final stage's stop of the unmasked call's;
   (13c) the rays between the transducers within 1 % of the analytic
   surface time and not above the straight path's; (13d)
   ``add_materials``' 45 degree table model against the same stiffness as
   a runtime Christoffel model, within 1e-3, and that model's rays; (13e)
   the kernels at the tutorial's shapes against their twins, max abs 0:
   K1 against the graphed twin at every stage of the gradient model's
   solve (a min pass, and a replace pass at the final shape) and at the
   final shape of the rays' two receivers, the 45 degree table model
   and the Christoffel model (a min pass), K2 and K3 on the facade's ray inputs of the gradient
   and the Christoffel models in float32 and float64; then K1 warm at 3
   x 201 x 201 and 2 x 201 x 201 on the gradient model beside its
   bound, its timed pass equal to the twin's;
14. K1's other forms (``csrc/sweep_forms.cu``: the FD-only and the
   FD-free operator, the parallel-in-block sweeps): (14a, float64 in
   phase 3's process, float32 in the main process while it waits for
   that one) each form against the graphed twin, max abs 0, on
   ``FORM_CASES`` (48 x 56 with every B in 4, 8, J in 1, 2,
   4, inner operator and accumulation; 37 x 131, the weld's 109 x 109
   patches and the tie-heavy isotropic 64 x 64), a pass whose sources
   are split between phase 1 and the polish, and the two-loop fixpoints
   on 48 x 56 in float64 with equal pass counts; (14b) the weld slice
   (phase 6's budgets and knobs) in each form of ``FORM_SLICES``
   (``final_polish_fd=False``, ``use_ali=False``,
   ``phase1_use_ali=False``, ``sweep_inner = patch_inner = 4`` with
   blocks 8 and 4, ``multigrid=True``, which must warn), each a warm-up
   run and a timed one with every count set to 0 just before it: its
   seconds, stage split, final passes, K1 launches by form and its
   fields' and ray times' deviation from phase 6's, every ray arrived;
   then ``ALI_FMM(solve_opts=final_polish_fd=False)`` timed likewise,
   its times equal to the direct path's; (14c) the qSV weld under
   ``for_mode("qsv", phase1_use_ali=False)`` under phase 11c's ray rules,
   its passes and deviation from 11c's fields; (14d) each form timed
   warm beside its bound (``form_ops``) and K1's default pass, at 31 x
   424 x 500 (FD-only, FD-free, B = 8 with J = 2 and 4) and at the
   tutorial's 3 x 201 x 201 (J = 2 and 4), each timed pass equal to its
   twin's.

15. BASELINE's fifth configuration, shear modes on a large grid on the
   halo path (four z slabs and 2 x 2 blocks of virtual ranks of the one
   card, ``virtual_mesh``; each solve with every count set to 0 just
   before it): (15a) the fine weld (s = 9, 31 fields of 3808 x 4492,
   float32, phase 9's budgets) through ``solve_ttf_halo`` on four z
   slabs, max abs 0 from phase 9's one-device fields (kept on the host)
   with equal passes and converged, its peak device memory and K5
   launches, the 961 nearest-point rays through it equal to phase 9's;
   one warm solve timed with its stage split and its rounds beside K1's
   fine pass; K5 at the fine final shape (a slab z-sweep, the refreshed
   x-sweep of the four slabs in one launch, a round) timed beside its
   bound; (15b) the qSV weld (phase 11c's model and ``for_mode("qsv")``)
   on four z slabs and on 2 x 2 blocks, max abs 0 from phase 11c's fields
   with equal passes and converged; (15c) the qSH weld (the qSV weld's
   layout with the qSH pair of ``generate_mode_curves(*QSV_STIFF,
   c66=QSH_C66, mode="qSH")``, ``for_mode("qsh")``): directly, the auto
   tracer directly and through ``ALI_FMM``, and on four z slabs; converged,
   every time finite and positive, the rays that do not arrive exactly
   those the JAX package does not land on the same fields (phase 11c's
   rule), each qSH time within ``QSH_OVER_QP`` of its qP time, the halo
   fields max abs 0 from the direct ones; (15d) homogeneous qSH against
   its closed-form elliptical
   first arrival, within the JAX package's own error on the same model
   (``tests/qsh_records.py``) plus a float32 margin;
16. K6, the model build's fallback slowness planes (``csrc/planes.cu``):
   against its twin (``grid._np_fallback_slowness_planes`` in float64 on
   the same inputs) on seed 0's weld, the table case of
   tests/test_torch_model.py and a mixed 48 x 56 case, in float32 (within
   ``PLANES_MAX_ULP`` float32 ulps) and float64 (``PLANES_RTOL_F64``);
   ``make_model`` on the card in both types (one launch a build, the
   other fields equal to the host upload) and on Fortran-ordered and
   transposed inputs; then timed at 424 x 500 (the profiler's device
   time, and CUDA events over 100 launches through the wrapper) beside its
   bound (the larger of its bytes and its float64 operations) and the
   host numpy planes it replaces.

The last lines are the card line, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --halo-fine`` runs the halo path's cases too long
for the default run's limit (406 s without its builds on an NVIDIA H100
80GB HBM3 at 700 W): the fine
weld on 2 x 2 blocks against one device, ``ALI_FMM(ttf_mode="grid",
grid_mesh=...)`` at s = 9 against the facade without a mesh, and the qSV
weld at s = 9 on one device and on four z slabs; it prints the card line
and one JSON object of the results.

``python3 chip_smoke.py --planes`` runs phase 16 alone in about a minute,
with K6's build and ptxas' report; it prints the card line and K6's
object of the kernels line.

``python3 chip_smoke.py --k4`` runs K4 alone in about a minute (K1 solves
its fields): on the weld's and the FMC's fields and on the slow band,
score_k 0 and 5, float32, against its twin and timed with its step split,
and again with every step exact; it prints the card line and one JSON
object of timings.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TOL_PASS = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_SOLVE = {torch.float64: 1e-10, torch.float32: 1e-4}
# The local update's fp32 operations per point, counted from csrc/sweep.cu
# (8 square stencils ~31, 8 triangular ~35, 8 FD quadrants ~30, 8 knight
# pairs ~20, then atan, two floor-mods and the phase velocity), and the
# H100's non-tensor fp32 peak and memory rate (SXM data sheet, 700 W).
# The phase velocity by its path (phase_velocity in csrc/sweep.cu): the
# closed-form Christoffel eigenvalue (velpn 0 with stiffness: cos and sin
# at about 20 each, 14 multiplies and adds, two square roots and a divide
# at about 10 each) about 85; the interpolated table column (column mode
# 2: a floor-mod about 10, a floor, clamps and two indices, two table
# loads, two multiply-adds and the scale) about 30; a constant column 3.
OPS_PER_UPDATE = 1000
OPS_PHASE_EIGEN, OPS_PHASE_LOOKUP, OPS_PHASE_CONSTANT = 85, 30, 3
# the FD fallback's share: 8 quadrants at ~30 and 8 knight pairs at ~20
# (the FD-only operator's whole update; the FD-free one skips it)
OPS_FD = 8 * 30 + 8 * 20
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# K6's float64 operations a point and wave angle, costed as above (a
# floor-mod, a divide or a square root about 10, cos and sin about 20, tan
# about 40, atan about 30): at a stiffness point the Christoffel solve
# (a floor-mod, the near-axis test, tan, B's divide, the root of the
# discriminant, atan's divide, atan, a floor-mod, cos and sin of the
# phase, the root and divide of the velocity, cos of the skew and its
# divide, about 30 multiplies and adds) about 250, at a table point the
# interpolation about 10; either way two floor-mods of the angle and the
# reciprocal about 30 more.  The H100's non-tensor fp64 peak (SXM data
# sheet, 700 W).
OPS_PLANES_CHRISTOFFEL, OPS_PLANES_TABLE = 280, 40
PEAK_FP64 = 33.5e12
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
# the nearest-point field sample (two roundings, two clamps, an index)
# about 8; a material sample that takes the Christoffel solve adds about
# 240, counted from materials.group_velocity_christoffel (tan, atan, two
# cos and sin at about 20 each, four divides and two square roots at
# about 10, some 50 more multiplies, adds, compares and selects)
OPS_NEAREST, OPS_CHRISTOFFEL = 8, 240
NO_LIBRARY = ("no PyTorch call computes a plane-search march or a "
              "cell-crossing integral")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


_T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's header ("[n] ...") with the seconds since
    the script started, so that each phase's cost can be read off."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock():
    """The SM clock now and its maximum, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
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


def weld_patches(half, factor, dtype, device, model=None):
    """Per-source patch models of the weld (three sources; ``model``: the
    seeded qP weld by default) with their analytic seeds: half 2 at 27x
    gives 109 x 109, half 13 at 3x 79 x 79."""
    from alifmm_tpu_torch import grid, solver, weld_data

    if model is None:
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
        solver._COARSE_SEED_SIDE, solver._SEED_SIGN)
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


def check_pass(model, tt, fixed, replace, dtype, what, configs=AUTO,
               graphed=False):
    """One plain pass against K1 at each launch shape, on the same inputs
    (``graphed``: the twin's lines replayed from a CUDA graph).  Returns
    the plain result and the largest absolute difference."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_p = sweep.gs_pass(tt, model, fixed, replace=replace, graphed=graphed)
    torch.cuda.synchronize()
    log(f"  {what}: {'graphed ' if graphed else ''}plain twin "
        f"{time.perf_counter() - t0:.1f} s")
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


def check_graphed(model, tt, fixed, replace, want, what):
    """The graphed twin (``sweep.gs_pass(graphed=True)``, which replays
    each line's operations from a CUDA graph) against the eager twin's
    result ``want``: the same kernels on the same values, so every bit
    must agree.  The fine final shape is checked with the graphed twin,
    where the eager one takes minutes a pass."""
    from alifmm_tpu_torch.ops import sweep

    got = sweep.gs_pass(tt, model, fixed, replace=replace, graphed=True)
    same = torch.equal(got, want)
    log(f"  {what}: graphed twin equal to the eager twin bit for bit: "
        f"{same}")
    check(same, f"{what}: the graphed twin differs from the eager twin")


def check_case(name, dtype, device):
    """A min pass, then a replace pass on its result, K1 against the plain
    twin, and the graphed twin against the eager one; returns the largest
    absolute difference."""
    make, configs = PASS_CASES[name]
    model, tt, fixed = make(dtype, device)
    dname = str(dtype).replace("torch.", "")
    mid, e1 = check_pass(model, tt, fixed, False, dtype,
                         f"{name} min {dname}", configs)
    check_graphed(model, tt, fixed, False, mid, f"{name} min {dname}")
    out, e2 = check_pass(model, mid, fixed, True, dtype,
                         f"{name} replace {dname}", configs)
    check_graphed(model, mid, fixed, True, out, f"{name} replace {dname}")
    return max(e1, e2)


def check_qsv_case(name, dtype, device):
    """A case of QSV_PASS_CASES: a min pass, then a replace pass on its
    result, K1 at the AUTO launch shapes against the graphed twin (which
    phase 3 holds bit for bit to the eager one), max abs 0; returns the
    largest absolute difference."""
    model, tt, fixed = QSV_PASS_CASES[name](dtype, device)
    dname = str(dtype).replace("torch.", "")
    mid, e1 = check_pass(model, tt, fixed, False, dtype,
                         f"{name} min {dname}", graphed=True)
    _, e2 = check_pass(model, mid, fixed, True, dtype,
                       f"{name} replace {dname}", graphed=True)
    check(e1 == 0.0 and e2 == 0.0,
          f"{name} {dname}: K1's interpolated lookup differs from its twin "
          f"(max abs {max(e1, e2):.3e})")
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


def check_segments(model_name, dtype, device, n=4096, exact=False):
    """The kernels' four segment integrators against segment_time_quad3,
    segment_time_quad, _segment_time_walk and segment_time on seeded
    segments, with the unified curve rows or (``exact``) the stiffness
    rows of the per-sample Christoffel solve.  Returns the largest
    absolute difference."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    model = ray_model(model_name, dtype, device)
    mat_flat = rays._material_flat(model, exact)
    dname = str(dtype).replace("torch.", "") + (" exact rows" if exact
                                                else "")
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
    """(mat_flat, tidx, src_xy, rec_xy, spec, final_cross, fast) of a
    march over ``pairs`` with trace_rays' ``knobs`` (``mode``,
    ``exact_materials`` and ``fast_step_scale`` among them) at ``s`` fine
    cells per model cell; ``fast`` is the uniform mask or None."""
    from alifmm_tpu_torch import rays, weld_data

    kw = dict(max_steps=None, max_cross=16, step_scale=1, quad_vel=False,
              cand_stride=1.0, plane_dist=3, near_step=1, fast_step_scale=0,
              mode="interp")
    kw.update({k: v for k, v in knobs.items() if k in kw})
    spec = rays.march_spec(model, s, **kw)
    _, _, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx, s)
    dev = model.device

    def on_dev(a, dt):
        return torch.as_tensor(a).to(dt).to(dev)

    final_cross = max(-(-kw["max_cross"] // 2) + 1,
                      max(spec.k_step, spec.k_fast) + 4)
    fast = (rays._uniform_mask(model, spec.k_fast + 4).reshape(-1)
            if spec.k_fast else None)
    mat_flat = rays._material_flat(model, knobs.get("exact_materials",
                                                    False))
    return (mat_flat, on_dev(tidx, torch.int64), on_dev(src_xy, model.dtype),
            on_dev(rec_xy, model.dtype), spec, final_cross, fast)


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
    mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
        model, *MARCH_KNOBS[knobs_name], sx, sy, pairs, dnx)
    args = (model, mat_flat, ttfs, tidx, src, rec, spec, fast)
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

    model, mat_flat, spec = args[0], args[1], args[6]
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


def near_vertical_segment(x_start, y1, s):
    """A near-vertical segment one model cell long in fine-grid coordinates,
    (x1, y1, x2, y1 + s): x2 the next float32 after x1, and x1 the first
    float32 from ``x_start`` on at which x1 / s and x2 / s are one float32:
    an integrator must difference such a segment's coordinates before it
    divides them by s, or it sees dx = 0 and takes the segment at 0
    degrees, as a horizontal one."""
    x1, sd = np.float32(x_start), np.float32(s)
    while True:
        x2 = np.nextafter(x1, np.float32(np.inf))
        if x1 / sd == x2 / sd:
            return float(x1), float(y1), float(x2), float(y1 + s)
        x1 = x2


# the near-vertical case on the weld: element 12 of the bottom row
# (x = 205, fine 1845), the segment a model cell above the bottom rows
NEAR_VERTICAL = dict(x_start=1845.0, y1=3600.0, s=9, cross=13)
TOL_NEAR_VERTICAL = 1e-5


def check_near_vertical(dtype, device):
    """The near-vertical segment (``NEAR_VERTICAL``) on the weld: the exact
    integrator (K2's EXACT scorer) and K3's ray times against their plain
    twins, bit for bit, and against the float64 twin within
    TOL_NEAR_VERTICAL.  Returns the relative gap to the float64 twin."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    nv = NEAR_VERTICAL
    s, cross = nv["s"], nv["cross"]
    seg = near_vertical_segment(nv["x_start"], nv["y1"], s)
    times = {}
    for dt in (dtype, torch.float64):
        model = ray_model("weld", dt, device)
        mat_flat = rays._material_flat(model)
        pts = [torch.tensor([v], dtype=dt, device=device) for v in seg]
        want = rays.segment_time(model, mat_flat, *pts, s, cross)
        got = cuda_rays.segments(model, mat_flat, cuda_rays.EXACT, *pts, s,
                                 cross)
        rx = torch.stack([pts[0], pts[2]], 1)
        ry = torch.stack([pts[1], pts[3]], 1)
        lens = torch.tensor([2], device=device)
        want_t = rays.ray_times_plain(model, mat_flat, rx, ry, lens, s, cross)
        got_t = cuda_rays.ray_times(model, mat_flat, rx, ry, lens, s, cross)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        log(f"  near-vertical segment {name}: exact integrator "
            f"{float(got):.9e} (twin {float(want):.9e}), K3 "
            f"{float(got_t):.9e} (twin {float(want_t):.9e})")
        check(torch.equal(got, want) and torch.equal(got_t, want_t),
              f"near-vertical segment {name}: a kernel differs from its twin")
        times[dt] = float(got_t)
    gap = abs(times[dtype] - times[torch.float64]) / times[torch.float64]
    log(f"  near-vertical segment: {dtype} against float64 {gap:.3e} "
        f"(tolerance {TOL_NEAR_VERTICAL:.0e})")
    check(gap <= TOL_NEAR_VERTICAL, "near-vertical segment: float32 time "
          "off the float64 one")
    return gap


def phase_rays_vs_plain(device):
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for name in RAY_MODELS:
            merge_worst(worst, dict(segments=check_segments(
                name, dtype, device)))
        for knobs_name in MARCH_KNOBS:
            merge_worst(worst, check_march(knobs_name, dtype, device))
        merge_worst(worst, dict(near_vertical=check_near_vertical(dtype,
                                                                  device)))
    return worst


def phase_analytic(device):
    """(5): the isotropic 424 x 500 field against r / v with the default
    budget and with ``SolveConfig.accuracy()``; then
    tests/test_analytic_truth.py's accuracy-preset cases."""
    from alifmm_tpu_torch import grid, solver

    Z, X, dnx, v = 424, 500, 2e-4, 5790.0
    model = grid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int),
                            v * np.ones((Z, X)), None, None, None, dnx,
                            dtype=torch.float32, device=device)
    sz, sx = 212, 250
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    want = dnx * np.hypot(zz - sz, xx - sx) / v
    mask = want > 0
    out = {}
    for preset, cfg in (("default", solver.SolveConfig()),
                        ("accuracy", solver.SolveConfig.accuracy())):
        t0 = time.perf_counter()
        tt, info = solver.solve_ttf(model, torch.tensor([sx * dnx]),
                                    torch.tensor([sz * dnx]), 1, cfg,
                                    return_info=True)
        got = tt[0].double().cpu().numpy()
        sec = time.perf_counter() - t0
        rel = np.abs(got - want)[mask] / want[mask]
        log(f"  isotropic 424x500, {preset} budget: rel err max "
            f"{rel.max():.4e} mean {rel.mean():.4e} (bounds {ANALYTIC_MAX}, "
            f"{ANALYTIC_MEAN}); final passes {info.passes} converged "
            f"{info.converged}; {sec:.3f} s")
        check(np.isfinite(got).all(), "analytic field not finite")
        check(rel.max() < ANALYTIC_MAX and rel.mean() < ANALYTIC_MEAN,
              f"analytic error out of bounds ({preset} budget)")
        out[preset] = dict(max=float(rel.max()), mean=float(rel.mean()),
                           passes=info.passes, converged=info.converged)
    out["accuracy_cases"] = accuracy_cases(device)
    return out


def accuracy_cases(device):
    """tests/test_analytic_truth.py's accuracy-preset cases on the card in
    float64 at their own sizes: homogeneous N x N (dnx 1e-3), one source
    in the centre, against t = d / v_group(veln - ray angle); isotropic
    v = 3000 and qP at veln 30 (the austenite of that file), N = 41 and
    81."""
    from alifmm_tpu_torch import grid, materials, solver

    dnx = 1e-3
    ang = np.arange(361.0)
    iso = np.stack([ang, np.ones(361)], 1)
    c = (263e9, 145e9, 216e9, 129e9, 7800)
    aniso = (np.stack([ang, materials.generate_group_vel_curve(*c)], 1),
             np.stack([ang, materials.generate_phase_vel_curve(*c)], 1))
    out = {}
    for name, veln0, g, p, vel, (b_max, b_mean) in (
            ("isotropic v=3000", 0.0, iso, iso, 3000.0, ACCURACY_ISO),
            ("qP veln=30", 30.0, *aniso, 1.0, ACCURACY_QP)):
        for N in (41, 81):
            model = grid.make_model(
                np.full((N, N), veln0), np.ones((N, N), dtype=int),
                vel * np.ones((N, N)), None, g, p, dnx, dtype=torch.float64,
                device=device)
            sz = sx = N // 2
            tt, info = solver.solve_ttf(
                model, np.array([sx * dnx]), np.array([sz * dnx]), 1,
                solver.SolveConfig.accuracy(), return_info=True)
            got = tt[0].cpu().numpy()
            zz, xx = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
            dz, dx = zz - sz, xx - sx
            a = np.where(dx == 0, 90.0, np.degrees(
                np.arctan(dz / np.where(dx == 0, 1, dx))))
            eff = np.mod(veln0 - a, 180.0)
            lo = np.floor(eff).astype(int)
            fr = eff - lo
            v = g[lo, 1] * (1 - fr) + g[np.minimum(lo + 1, 360), 1] * fr
            want = dnx * np.hypot(dz, dx) / (v * vel)
            mask = want > 0
            rel = np.abs(got - want)[mask] / want[mask]
            log(f"  accuracy preset, {name}, N={N}: rel err max "
                f"{rel.max():.4e} mean {rel.mean():.4e} (bounds {b_max}, "
                f"{b_mean}); final passes {info.passes} converged "
                f"{info.converged}")
            check(np.isfinite(got).all()
                  and rel.max() < b_max and rel.mean() < b_mean,
                  f"accuracy preset {name} N={N}: error out of bounds")
            out[f"{name}, N={N}"] = dict(max=float(rel.max()),
                                         mean=float(rel.mean()),
                                         passes=info.passes)
    return out


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


def run_slice(inputs, progress=None, cfg=None):
    """solve_ttf, then trace_rays(mode="interp") with the weld's knobs
    (``cfg``: the weld's budgets by default)."""
    from alifmm_tpu_torch import rays, solver, weld_data

    model, scx, scz, src_xy, rec_xy, tidx = inputs
    cfg = solver.SolveConfig(**SOLVE_KW) if cfg is None else cfg
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
    from alifmm_tpu_torch.ops import cuda_planes, cuda_rays, cuda_sweep, sweep

    cuda_sweep.LAUNCHES = 0
    cuda_sweep.SLAB_LAUNCHES = 0
    cuda_planes.LAUNCHES = 0
    for name in cuda_sweep.FORM_LAUNCHES:
        cuda_sweep.FORM_LAUNCHES[name] = 0
    sweep.CALLS = 0
    rays.PLAIN_STEPS = 0
    for name in cuda_rays.LAUNCHES:
        cuda_rays.LAUNCHES[name] = 0


def read_counts():
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_planes, cuda_rays, cuda_sweep, sweep

    return dict(sweep_pass=cuda_sweep.LAUNCHES,
                slab_sweep=cuda_sweep.SLAB_LAUNCHES, plain_passes=sweep.CALLS,
                planes=cuda_planes.LAUNCHES,
                plain_steps=rays.PLAIN_STEPS, **cuda_rays.LAUNCHES,
                **{f"k1_{k}": v for k, v in cuda_sweep.FORM_LAUNCHES.items()})


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
    return inputs, ttfs, times, (wall, t_solve, t_rays)


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

    spec = args[6]
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
    model, mat_flat = args[0], args[1]
    stiff = (mat_flat[:, 1] == 0 if mat_flat.shape[1] == 8 and model.has_stif
             else None)
    fracs = {cuda_rays.SIMPSON3: (0.0, 0.5, 1.0),
             cuda_rays.SIMPSON5: (0.0, 0.25, 0.5, 0.75, 1.0)}.get(
                 spec.scorer, (0.5,))
    chr_hits = chr_all = 0
    for k, (x1, y1, x2, y2) in enumerate(calls):
        live = torch.ones(x2.shape, dtype=torch.bool, device=x2.device)
        live[:, 1:] = (x2[:, 1:] != x2[:, :-1]) | (y2[:, 1:] != y2[:, :-1])
        live &= (steps > k)[:, None]
        if stiff is not None:
            # the cells the Simpson samples (the walk: the midpoints) hit
            for f in fracs:
                xi = torch.round((x1 + (x2 - x1) * f) / spec.s).long().clamp(
                    0, model.shape[1] - 1)
                yi = torch.round((y1 + (y2 - y1) * f) / spec.s).long().clamp(
                    0, model.shape[0] - 1)
                chr_hits += int((stiff[yi * model.shape[1] + xi] & live).sum())
                chr_all += int(live.sum())
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
    work["christoffel_share"] = chr_hits / chr_all if chr_all else 0.0
    check(work["steps"] == int(steps.sum()), "march work: steps miscounted")
    log(f"  march twin {ms:.1f} ms; the kernel's work: {work['steps']} "
        f"steps, {work['candidates']} candidates scored "
        f"({work['candidates'] / work['steps']:.2f} a step, K = {spec.K}), "
        f"{work['samples']} material samples "
        f"({work['samples'] / work['candidates']:.3f} a candidate, "
        f"{work['christoffel_share']:.3f} of them Christoffel solves); "
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
    crossing intervals x one material sample).

    With the nearest-point tap (``spec.grid``) a scored candidate reads
    one field cell and its sample costs OPS_NEAREST.  With 8-column rows
    (exact materials) the velocity table is the group table, and the share
    of material samples in stiffness cells (``work["christoffel_share"]``
    for the march; for K3 the share of its vertices' cells) adds
    OPS_CHRISTOFFEL each."""
    item = ttfs.element_size()
    R, P = bx.shape
    K = spec.K
    row = mat_flat.shape[1] * item
    all_rows = mat_flat.shape[0] * row
    exact = mat_flat.shape[1] == 8
    table = model.group_tab if exact else model.ray_curves
    curves = min(table.shape[0], 181) * table.shape[1] * item
    n_steps = work["steps"]
    span = int((K - 1) * spec.stride / spec.s) + 2
    fan = (min(-(-work["samples"] // work["candidates"]),
               spec.plane_dist + 1) * span // 2 + 1)
    sample_ops = OPS_SAMPLE + work.get("christoffel_share", 0.0) * OPS_CHRISTOFFEL
    march_ops = (n_steps * OPS_PLANE + work["columns"] * OPS_COLUMN
                 + work["candidates"] * ((OPS_NEAREST if spec.grid
                                          else OPS_BILINEAR) + OPS_SEGMENT)
                 + work["samples"] * sample_ops)
    field_cells = work["candidates"] if spec.grid else n_steps * 2 * span
    march_bytes = (min(ttfs.numel(), field_cells) * item
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
    k3_sample = OPS_SAMPLE
    if exact and model.has_stif:
        Z, X = model.shape
        xi = torch.round(bx / spec.s).long().clamp(0, X - 1)
        yi = torch.round(by / spec.s).long().clamp(0, Z - 1)
        stiff = (mat_flat[:, 1] == 0)[yi * X + xi][:, :-1]
        k3_sample += float(stiff[real].double().mean()) * OPS_CHRISTOFFEL
    k3_ops = (moving * (6 * (OPS_SEGMENT + relax_samples * k3_sample) + 40)
              + int(real.sum()) * OPS_SEGMENT + intervals * k3_sample)
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
    over n calls), the longest ray's steps, the blocks resident per SM and
    a march of every 8th ray; with the unified curves and the bilinear
    tap, also the step split by part (the clock64 build, on the longest
    ray), which exists for that build only."""
    from alifmm_tpu_torch.ops import cuda_rays

    spec = args[6]
    p = cuda_rays.prepare_march(*args)
    bare = time_events(p.run, n)
    wrapper = time_events(lambda: cuda_rays.march(*args), n)
    steps = p.out[4]
    chain = int(steps.max())
    us = bare * 1e3 / chain
    split = None
    if (p.plan["mat_kind"], p.plan["tap"]) == (cuda_rays.MAT_CURVES,
                                                cuda_rays.TAP_BILINEAR):
        pp = cuda_rays.prepare_march(*args, profile=True)
        pp.run()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(pp.out[:5], p.out)),
              "the march's profiling build marched otherwise")
        cyc = pp.out[5][int(torch.argmax(steps))].double()
        split = dict(zip(("scoring", "reduction", "rest"),
                         (cyc / cyc.sum()).tolist()))
    warps = cuda_rays.occupancy(p, spec.scorer, torch.float32) * 4
    # the same march over every 8th ray, fewer than one block an SM: what
    # a step takes when its warps do not share the SM's issue slots
    few = [a[::8].contiguous() for a in args[3:6]]
    pf = cuda_rays.prepare_march(*args[:3], *few, *args[6:])
    us_alone = time_events(pf.run, n) * 1e3 / int(pf.out[4].max())
    parts = ("" if split is None else
             f", of which scoring {split['scoring']:.3f}, reduction "
             f"{split['reduction']:.3f}, the rest {split['rest']:.3f} "
             f"(clock64 on that ray: {us * split['scoring']:.3f} / "
             f"{us * split['reduction']:.3f} / {us * split['rest']:.3f} us)")
    log(f"  K2 {bare:.4f} ms bare, {wrapper:.4f} ms through the wrapper, for "
        f"{args[3].shape[0]} rays (K = {spec.K}, {p.plan['lanes']} lanes "
        f"a ray, curves in {'shared' if p.plan['curves_smem'] else 'device'}"
        f" memory, {p.plan['smem']} B); the longest ray takes {chain} "
        f"dependent steps: {us:.3f} us a step{parts}; all rays "
        f"{int(steps.sum())} steps; {warps} warps resident per SM; every "
        f"8th ray alone: {us_alone:.3f} us a step")
    out = dict(ms=bare, wrapper_ms=wrapper, chain=chain, us_per_step=us,
               us_per_step_few_rays=us_alone, lanes=p.plan["lanes"],
               warps_per_sm=warps, steps=int(steps.sum()))
    if split is not None:
        out["step_split"] = split
    return out


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
        mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
            model, *MARCH_KNOBS["weld knobs"], sx, sy, pairs, dnx)
        args = (model, mat_flat, fields, tidx, src, rec, spec, fast)
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

    mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
        model, dict(), 9, *geometry)
    args = (model, mat_flat, ttfs, tidx, src, rec, spec, fast)
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


def stage_inputs(inputs, cfg=None):
    """Each stage's K1 input in the weld solve (``cfg``: the weld's budgets
    by default), as solver._stage_first, _stage_next and _stage_final build
    them: (name, model, field, fixed)."""
    from alifmm_tpu_torch import solver

    model, scx, scz = inputs[:3]
    cfg = solver.SolveConfig(**SOLVE_KW) if cfg is None else cfg
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
                solver._SEED_SIGN)
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


def update_ops(packed):
    """Operations of one point's update, (Bm, Z, X), by the path its phase
    velocity takes: OPS_PER_UPDATE with the Christoffel eigenvalue, that
    less the eigenvalue plus the lookup for an interpolated table column,
    or plus 3 for a constant one."""
    velpn = packed.planes[:, 1].long()
    M = packed.col_mode.numel()
    mode = packed.col_mode.long()[velpn.clamp(0, M - 1)]
    mode = torch.where((velpn >= 0) & (velpn < M), mode, 0)
    base = OPS_PER_UPDATE - OPS_PHASE_EIGEN
    ops = torch.where(mode == 2, base + OPS_PHASE_LOOKUP,
                      base + OPS_PHASE_CONSTANT)
    if packed.has_stif:
        ops = torch.where(velpn == 0, OPS_PER_UPDATE, ops)
    return ops


def form_ops(packed, form):
    """``update_ops`` for a pass of ``form`` (``sweep.Form``): the FD
    fallback alone (``OPS_FD``: no stencil selection, no finish), the
    update without it, and J updates a line in the parallel-in-block
    order."""
    ops = update_ops(packed)
    if not form.use_ali:
        ops = torch.full_like(ops, OPS_FD)
    elif not form.use_fd:
        ops = ops - OPS_FD
    return ops * max(form.inner, 1)


def bound_ms(tt, fixed, packed, form=None):
    """The least time one pass could take on an H100 (SXM data sheet, 700
    W): the larger of its fp32 operations over 67 TFLOP/s and its bytes
    over 3.35 TB/s.  Operations: 4 sweeps x the points that are not fixed
    x each point's ``update_ops`` (``form_ops`` for another form); bytes:
    the field read and written once, the fixed mask and the 12 material
    planes read once."""
    per = update_ops(packed) if form is None else form_ops(packed, form)
    free = (~fixed).sum(0, keepdim=True) if per.shape[0] == 1 else ~fixed
    ops = 4 * int((per * free).sum())
    item = tt.element_size()
    nbytes = (2 * tt.numel() * item + fixed.numel()
              + packed.planes.numel() * item)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_k1(tt, fixed, packed, cluster=None, lanes=None, n=10, form=None,
            replace=False):
    """Warm K1 time per pass (ms), CUDA events over n launches (``form``:
    a ``sweep.Form``, the default one if None)."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    B = tt.shape[0]
    rep, act = np.full(B, bool(replace)), np.ones(B, bool)
    kw = dict(form=sweep.DEFAULT if form is None else form)
    out, _, _ = cuda_sweep._launch(tt, fixed, packed, rep, act, cluster, lanes,
                                   **kw)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        cuda_sweep._launch(tt, fixed, packed, rep, act, cluster, lanes, **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, out


def phase_pass_timing(inputs):
    """K1 warm at every stage shape of the weld solve (float32), beside its
    bound; launch shapes compared at each; one plain pass at the final
    shape, on the graphed twin."""
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
    # the graphed twin, which phase 3 holds bit for bit to the eager one
    # (the eager pass takes 45-96 s here, host-bound)
    t0 = time.perf_counter()
    out_p = sweep.gs_pass(tt0, model, fixed, replace=False, graphed=True)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    abs_e, rel_e = rel_err(out_k, out_p)
    log(f"  {name} graphed plain twin {ms_p:.1f} ms per pass; K1 against "
        f"it: max abs {abs_e:.3e} max rel {rel_e:.3e}")
    check(rel_e <= TOL_PASS[torch.float32], "final-shape pass differs")
    return shapes, ms_p, abs_e


# --------------------------------------------------------------------- #
# The fine-grid path: solve_ttf(subgrid_size > 1), trace_rays(mode="grid"),
# exact materials and fast strides
# --------------------------------------------------------------------- #

# The ray kernels' new paths against their twins on 48 x 56: (trace_rays
# knobs, fine cells per model cell, model, whether the fields lie on the
# refined grid).  The fast-stride case takes tests/test_rays_r5.py's
# knobs on a model that is uniform away from a slow band.
FINE_MARCH_CASES = {
    "grid tap, facade defaults": (dict(mode="grid"), 3, "48x56", True),
    "grid tap, weld knobs": (dict(RAY_OPTS, mode="grid"), 3, "48x56", True),
    "exact materials, weld knobs": (dict(RAY_OPTS, exact_materials=True), 9,
                                    "48x56", False),
    "exact materials, facade defaults": (dict(exact_materials=True), 3,
                                         "48x56", False),
    "grid tap and exact materials, weld knobs": (
        dict(RAY_OPTS, mode="grid", exact_materials=True), 3, "48x56", True),
    "grid tap and exact materials, Simpson 5": (
        dict(mode="grid", quad_vel=True, exact_materials=True), 3, "48x56",
        True),
    "fast stride": (dict(step_scale=2, fast_step_scale=6, max_steps=80,
                         quad_vel=3), 3, "slow band", False),
}


def slow_band_model(dtype, device):
    """48 x 56 isotropic 3000 m/s with a slow band (1500 m/s) across row
    24: the fast-stride mask is True away from the band, False near it."""
    from alifmm_tpu_torch import grid

    Z, X = 48, 56
    vel = 3000.0 * np.ones((Z, X))
    vel[24] = 1500.0
    return grid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int), vel,
                           None, None, None, 2e-4, dtype=dtype, device=device)


def check_fine_march(case, dtype, device):
    """One case of FINE_MARCH_CASES: fields solved on the card (on the
    refined grid for the grid tap), K2 against march_plain (bare launches
    with the tables in shared and in device memory, and through the
    wrapper), then K3 on the twin's polylines with every scorer.  Returns
    the largest differences by kernel."""
    from alifmm_tpu_torch import rays, solver, weld_data

    knobs, s, model_name, fine = FINE_MARCH_CASES[case]
    model = (small_model(dtype, device) if model_name == "48x56"
             else slow_band_model(dtype, device))
    dnx = float(model.dnx)
    sx, sy, pairs = weld_data.transducers(model.shape, dnx, 5, 10)
    scx, scz = weld_data.ray_pairs(sx, sy, pairs, dnx)[:2]
    ttfs = solver.solve_ttf(model, torch.as_tensor(scx), torch.as_tensor(scz),
                            s if fine else 1, solver.SolveConfig(**SOLVE_KW))
    mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
        model, knobs, s, sx, sy, pairs, dnx)
    if fast is not None:
        share = float(fast.double().mean())
        check(0.0 < share < 1.0, f"{case}: uniform mask share {share}")
    args = (model, mat_flat, ttfs, tidx, src, rec, spec, fast)
    want = rays.march_plain(*args)
    what = f"48x56 {case} {str(dtype).replace('torch.', '')}"
    log(f"  {what}: fields {tuple(ttfs.shape)}, rows of "
        f"{mat_flat.shape[1]} columns"
        + ("" if fast is None else f", uniform mask share {share:.3f}"))
    errs = march_vs_twin(args, want, final_cross, dtype, what)
    if mat_flat.shape[1] == 8:
        merge_worst(errs, check_k3(model, mat_flat, *want[:3], spec.s,
                                   final_cross, dtype, what,
                                   single_waves=False))
    return errs


def phase_fine_rays_vs_plain(device):
    """(a): the segment integrators on stiffness rows, and K2 and K3 on
    every case of FINE_MARCH_CASES, in float64 and float32."""
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for name in RAY_MODELS:
            merge_worst(worst, dict(segments=check_segments(
                name, dtype, device, exact=True)))
        for case in FINE_MARCH_CASES:
            merge_worst(worst, check_fine_march(case, dtype, device))
    return worst


def fine_weld_patches(half, factor, dtype, device):
    """Per-source patches of the fine weld (four sources, on the top and
    the bottom) with the fine path's analytic seed (side 40):
    half 22 at 9x gives the first stage's 397 x 397, half 49 at 3x the
    second stage's 295 x 295."""
    from alifmm_tpu_torch import grid, solver, weld_data

    fine = grid.refine_model(ray_model("weld", dtype, device),
                             weld_data.SUBGRID)
    scx = torch.tensor([60.0, 180.0, 320.0, 440.0], dtype=dtype,
                       device=device) * weld_data.DNX
    scz = torch.tensor([0.0, 0.0, 423.0, 423.0], dtype=dtype,
                       device=device) * weld_data.DNX
    isz, isx = solver._source_cells(fine, scx, scz)
    hz, hx, bz, bx = solver._window(fine, isz, isx, half)
    patches = solver._slice_model(fine, bz, bx, hz, hx, factor)
    side = solver.fine_stage_params(weld_data.SUBGRID)[1]
    tt, fixed = solver._analytic_seed(
        patches, fine, isz, isx, (isz - bz) * factor, (isx - bx) * factor,
        side, solver._SEED_SIGN)
    return patches, tt, fixed


FINE_PASS_CASES = {
    "fine patches 397x397": lambda dt, dev: fine_weld_patches(22, 9, dt, dev),
    "fine patches 295x295": lambda dt, dev: fine_weld_patches(49, 3, dt, dev),
}


def phase_fine_k1_vs_plain(device):
    """(b): K1 against its plain twin at the fine path's patch shapes, four
    sources, float64 and float32: one min pass from the analytic seed at
    both lane counts.  The twin is the graphed one, which phase 3 holds
    equal to the eager twin bit for bit (5-7 s a pass here, the eager one
    about 50 s)."""
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for name, make in FINE_PASS_CASES.items():
            model, tt, fixed = make(dtype, device)
            _, e = check_pass(model, tt, fixed, False, dtype,
                              f"{name} min {str(dtype)[6:]}", graphed=True)
            worst = max(worst, e)
    return worst


def phase_analytic_fine(device):
    """(c): solve_ttf(subgrid_size=9) on the 424 x 500 isotropic model of
    phase_analytic, one interior source, against r / v on the refined
    grid (3808 x 4492), to the bounds of tests/test_analytic_truth.py."""
    from alifmm_tpu_torch import grid, solver

    Z, X, dnx, v, s = 424, 500, 2e-4, 5790.0, 9
    model = grid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int),
                            v * np.ones((Z, X)), None, None, None, dnx,
                            dtype=torch.float32, device=device)
    sz, sx = 212, 250
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt, info = solver.solve_ttf(model, torch.tensor([sx * dnx]),
                                torch.tensor([sz * dnx]), s,
                                solver.SolveConfig(), return_info=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = tt[0].double()
    FZ, FX = got.shape
    check((FZ, FX) == ((Z - 1) * s + 1, (X - 1) * s + 1),
          f"fine field shape {(FZ, FX)}")
    zz = torch.arange(FZ, dtype=torch.float64, device=device)[:, None]
    xx = torch.arange(FX, dtype=torch.float64, device=device)[None, :]
    want = (dnx / s) * torch.hypot(zz - sz * s, xx - sx * s) / v
    mask = want > 0
    rel = (got - want).abs()[mask] / want[mask]
    mx, mean = float(rel.max()), float(rel.mean())
    log(f"  isotropic 424x500 at s = 9 ({FZ}x{FX}): rel err max {mx:.4e} "
        f"mean {mean:.4e} (bounds {ANALYTIC_MAX}, {ANALYTIC_MEAN}); final "
        f"passes {info.passes} converged {info.converged}; {sec:.3f} s")
    check(bool(torch.isfinite(got).all()), "fine analytic field not finite")
    check(mx < ANALYTIC_MAX and mean < ANALYTIC_MEAN,
          "fine analytic error out of bounds")
    return dict(max_rel=mx, mean_rel=mean, passes=int(info.passes),
                seconds=sec)


def run_fine_slice(inputs, progress=None, exact=False):
    """The fine weld slice directly: solve_ttf(subgrid_size=9), then
    trace_rays(mode="grid") with the weld's knobs."""
    from alifmm_tpu_torch import rays, solver, weld_data

    model, scx, scz, src_xy, rec_xy, tidx = inputs
    cfg = solver.SolveConfig(**SOLVE_KW)
    t0 = time.perf_counter()
    ttfs, info = solver.solve_ttf(model, scx, scz, weld_data.SUBGRID, cfg,
                                  progress=progress, return_info=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = rays.trace_rays(model, ttfs, tidx, src_xy, rec_xy,
                          weld_data.SUBGRID, mode="grid", return_reason=True,
                          exact_materials=exact, **RAY_OPTS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ttfs, info, out, (t1 - t0, t2 - t1, t2 - t0)


def check_rays_arrive(out, what):
    """961 rays with finite positive times that arrived; otherwise fail
    with how many did not and why."""
    bx, by, lengths, times, reason = out
    check(times.shape == (961,), f"{what}: times shape {tuple(times.shape)}")
    reasons = {int(k): int(v) for k, v in
               zip(*np.unique(reason.cpu().numpy(), return_counts=True))}
    arrived = (reason == 0) & (lengths - 2 < RAY_OPTS["max_steps"])
    ok_t = torch.isfinite(times) & (times > 0)
    log(f"  {what}: rays by reason (0 arrived, 1 plane left grid, 2 "
        f"truncated) {reasons}; arrived within the step budget "
        f"{int(arrived.sum())}; finite positive times {int(ok_t.sum())}")
    check(int(arrived.sum()) == 961 and bool(ok_t.all()),
          f"{what}: {961 - int(arrived.sum())} of 961 rays did not arrive "
          f"(reasons {reasons}), {961 - int(ok_t.sum())} times not finite "
          f"and positive")


def time_gap(got, want):
    """(max, median) of |got - want| / want over the rays."""
    rel = ((got.double() - want.double()).abs() / want.double()).cpu()
    return float(rel.max()), float(rel.median())


def phase_fine_slice(inputs, coarse_times):
    """(d): the fine weld slice (31 fields of 3808 x 4492, 961 rays, f32):
    the direct path warm-up, then timed with the counts set to 0 just
    before it, with its stage split, passes, launches and peak device
    memory; its ray times against the interp-mode times of the coarse
    slice; the ray phase again with exact materials on the same fields
    (the solve does not depend on them), timed; then through the facade
    (ALI_FMM(ttf_mode="grid").find_all_TTF_rays_parallel, warm), timed
    with the counts set to 0 just before it."""
    from alifmm_tpu_torch import rays, weld_data
    from alifmm_tpu_torch.ops.stencils import INF

    t0 = time.perf_counter()
    run_fine_slice(inputs)
    log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ttfs, info, out, (t_solve, t_rays, wall) = run_fine_slice(inputs, rec)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  direct fine weld slice warm wall clock {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s); peak device memory "
        f"{peak:.3f} GB")
    for name, sec in stages:
        log(f"    stage [{name}] {sec:.4f} s")
    log(f"  final stage passes {info.passes} converged {info.converged}")
    log(f"  launches and plain-twin counts: {counts}")
    check_counts(counts, "the direct fine weld slice")
    FZ, FX = (424 - 1) * 9 + 1, (500 - 1) * 9 + 1
    check(tuple(ttfs.shape) == (31, FZ, FX),
          f"fine field shape {tuple(ttfs.shape)}")
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          "fine weld fields not finite everywhere")
    check_rays_arrive(out, "fine slice, grid mode")
    gmax, gmed = time_gap(out[3], coarse_times)
    log(f"  ray times, grid mode (s = 9 fields) against interp mode (model-"
        f"grid fields): max rel {gmax:.4e}, median rel {gmed:.4e}")

    model, _, _, src_xy, rec_xy, tidx = inputs
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = rays.trace_rays(model, ttfs, tidx, src_xy, rec_xy, weld_data.SUBGRID,
                         mode="grid", return_reason=True,
                         exact_materials=True, **RAY_OPTS)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    ex_counts = read_counts()
    check(ex_counts["march"] == 1 and ex_counts["relax_times"] == 1
          and ex_counts["plain_steps"] == 0,
          f"the exact-material rays launched {ex_counts}")
    check_rays_arrive(ex, "fine slice, grid mode, exact materials")
    emax, emed = time_gap(ex[3], out[3])
    log(f"  exact materials: ray phase {t_exact:.4f} s; ray times against "
        f"the unified curves': max rel {emax:.4e}, median rel {emed:.4e}")

    fa = phase_fine_facade(out[3])
    return dict(ttfs=ttfs, out=out, wall=wall, solve=t_solve, rays=t_rays,
                stages=stages, passes=int(info.passes),
                converged=bool(info.converged), counts=counts, peak_gb=peak,
                gap_max=gmax, gap_median=gmed, exact_rays=t_exact,
                exact_gap_max=emax, exact_gap_median=emed, **fa)


def phase_fine_facade(direct_times):
    """The fine slice through ALI_FMM(ttf_mode="grid")
    .find_all_TTF_rays_parallel(subgrid_size=9), after the direct path's
    warm-up, with every count set to 0 just before the call."""
    import alifmm_tpu_torch
    from alifmm_tpu_torch import weld_data

    alifmm_tpu_torch.tqdm_disable = True
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy, stif_den=stif,
                                  dnx=dnx, ray_opts=RAY_OPTS,
                                  solve_opts=SOLVE_KW, ttf_mode="grid")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmat = fm.find_all_TTF_rays_parallel(veln, velpn, vel_map,
                                         subgrid_size=weld_data.SUBGRID,
                                         stif_den=stif, trans_pairs=pairs,
                                         n_threads=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  facade (ttf_mode='grid', subgrid_size=9) {wall:.4f} s; launches "
        f"and plain-twin counts: {counts}")
    check_counts(counts, "the facade's fine weld run")
    top, bottom = slice(0, 31), slice(31, 62)
    check(tmat.shape == (62, 62), f"time matrix shape {tmat.shape}")
    block = tmat[top, bottom]
    check(bool(np.isfinite(tmat).all()) and bool((block > 0).all()),
          "fine top-to-bottom ray times not finite and positive")
    rest = tmat.copy()
    rest[top, bottom] = 0
    check(not rest.any(), "time matrix not zero outside the traced pairs")
    d = np.abs(block.reshape(-1) - direct_times.double().cpu().numpy())
    rel = float((d / block.reshape(-1)).max())
    log(f"  facade ray times against the direct path's: max rel {rel:.3e}")
    check(rel <= 1e-6, "the facade's fine ray times differ from the direct "
          "path's")
    return dict(facade_wall=wall, facade_counts=counts)


def fine_stage_inputs(inputs):
    """Each stage's K1 input in the fine weld solve, as
    solver._staged_solve builds them on the refined model: (name, model,
    field, fixed)."""
    from alifmm_tpu_torch import grid, solver, weld_data

    model, scx, scz = inputs[:3]
    fine = grid.refine_model(model, weld_data.SUBGRID)
    cfg = solver.SolveConfig(**SOLVE_KW)
    stages, side = solver.fine_stage_params(weld_data.SUBGRID)
    isz, isx = solver._source_cells(fine, scx, scz)
    out = []
    tt = bz = bx = None
    for k, (half, factor) in enumerate(stages):
        hz, hx, nbz, nbx = solver._window(fine, isz, isx, half)
        patches = solver._slice_model(fine, nbz, nbx, hz, hx, factor)
        if k == 0:
            t0, fixed = solver._analytic_seed(
                patches, fine, isz, isx, (isz - nbz) * factor,
                (isx - nbx) * factor, side, solver._SEED_SIGN)
        else:
            t0, fixed = solver._inject(tt, bz, bx, 3 * factor, patches.shape,
                                       nbz, nbx, factor, fine.shape)
        Z, X = patches.shape
        out.append((f"fine s{k + 1} patches {Z}x{X}", patches, t0, fixed))
        tt, _ = solver._patch_solve(t0, patches, fixed, cfg)
        bz, bx = nbz, nbx
    zero = torch.zeros_like(bz)
    t0, fixed = solver._inject(tt, bz, bx, 3, fine.shape, zero, zero, 1,
                               fine.shape)
    Z, X = fine.shape
    out.append((f"fine final {Z}x{X}", fine, t0, fixed))
    return out


def as_float64(model):
    """The model with its floating tensors in float64."""
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).double()
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
        and getattr(model, f.name).is_floating_point()})


def known_gap(a, b):
    """|a - b| (float64) where both are known, else 0."""
    from alifmm_tpu_torch.ops.stencils import INF

    a, b = a.double(), b.double()
    both = (a < INF * 0.5) & (b < INF * 0.5)
    return torch.where(both, (a - b).abs(), 0.0)


def k1_fine_float64(model, tt0, fixed, packed):
    """One K1 pass in float64 at the fine final shape, where the field
    stack (31 x 3808 x 4492 x 8 B = 4.2 GB) passes 2^31 bytes and one CTA
    fits an SM.  The last source's field, which starts 4.1 GB into the
    stack, must equal bit for bit the pass over that source alone (the
    same launch shape, C = 8, G = 4, at offset 0).  The float32 pass on
    the same input is compared with it source by source; the source with
    the largest gap is returned for k1_fine_vs_twin."""
    from alifmm_tpu_torch.ops import cuda_sweep
    from alifmm_tpu_torch.ops.stencils import INF

    f64 = as_float64(model)
    B = tt0.shape[0]
    p64 = cuda_sweep.pack_model(f64)
    t64 = tt0.double()
    ms, out64 = time_k1(t64, fixed, p64, n=1)
    one = np.zeros(1, bool), np.ones(1, bool)
    last, _, _ = cuda_sweep._launch(t64[-1:].contiguous(),
                                    fixed[-1:].contiguous(), p64, *one)
    out32, _, _ = cuda_sweep._launch(tt0, fixed, packed, np.zeros(B, bool),
                                     np.ones(B, bool))
    torch.cuda.synchronize()
    abs_last, _ = rel_err(out64[-1:], last)
    gaps = torch.stack([known_gap(out32[b], out64[b]).max()
                        for b in range(B)])
    worst = int(torch.argmax(gaps))
    scale = float(out64[out64 < INF * 0.5].max())
    log(f"  fine final K1 float64 ({t64.numel() * 8 / 1e9:.2f} GB field "
        f"stack) {ms:.1f} ms per pass; the last source against its pass "
        f"alone: max abs {abs_last:.3e} (must be 0); the float32 pass "
        f"against it: max abs {float(gaps.max()):.3e} s "
        f"({float(gaps.max()) / scale:.3e} of the field's largest time), "
        f"largest in source {worst}; sources with a gap over 1e-3 of that "
        f"time: {int((gaps > 1e-3 * scale).sum())} of {B}")
    check(abs_last == 0.0, "K1 float64 at the fine final shape: the last "
          "source differs from its pass alone")
    del f64, p64, t64, out64, out32, last
    return dict(ms=ms, max_abs_last_source_alone=abs_last,
                max_abs_vs_float32_over_scale=float(gaps.max()) / scale,
                worst_source=worst)


def k1_fine_vs_twin(model, tt0, fixed, b):
    """(b) at the fine final shape, for source ``b`` alone: one min pass of
    K1 (at the wrapper's own launch shape, and with 8 lanes) against the
    graphed plain twin, in float32 and float64, max abs 0.  Then where the
    float32 and float64 passes differ most, with both twins' values
    there."""
    from alifmm_tpu_torch.ops import cuda_sweep

    tt1, fx1 = tt0[b:b + 1].contiguous(), fixed[b:b + 1].contiguous()
    Z, X = tt1.shape[1:]
    C, G = cuda_sweep.launch_config(1, Z, X, cuda_sweep._sm_count(
        tt1.device))
    outs, res = {}, {}
    for dtype in (torch.float32, torch.float64):
        m = model if dtype == torch.float32 else as_float64(model)
        name = str(dtype)[6:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, e = check_pass(m, tt1.to(dtype), fx1, False, dtype,
                            f"fine final {Z}x{X} source {b} min {name}",
                            graphed=True)
        sec = time.perf_counter() - t0
        log(f"  fine final {Z}x{X} source {b} {name}: graphed twin and two "
            f"K1 passes {sec:.1f} s (launch_config C={C} G={G})")
        check(e == 0.0, f"K1 at the fine final shape, source {b}, {name}: "
              f"max abs {e:.3e} against the twin (must be 0)")
        outs[name], res[name] = out[0], dict(max_abs=e, seconds=sec)
        del m, out
    gap = known_gap(outs["float32"], outs["float64"])
    k = int(torch.argmax(gap))
    z, x = divmod(k, X)
    v32, v64 = float(outs["float32"][z, x]), float(outs["float64"][z, x])
    log(f"  source {b}, one min pass: float32 against float64 max abs "
        f"{float(gap.max()):.3e} s at (z, x) = ({z}, {x}); twin (= K1) "
        f"float64 {v64:.9e} s, float32 {v32:.9e} s")
    res.update(cluster=C, lanes=G, gap_at=(z, x), gap_float64=v64,
               gap_float32=v32)
    return res


def gap_by_pass(model, tt0, fixed, b, min_passes=16, polish=2):
    """Why float32 and float64 differ after one pass: K1 passes for source
    ``b`` from the same injected state in both types (min passes, then
    replace passes, as the final stage runs them), the largest gap after
    each pass beside the float64 pass-to-pass delta.  A gap that shrinks as
    the passes converge comes from values not yet settled, where a
    candidate's acceptance flips between the types; a fault would not
    shrink."""
    from alifmm_tpu_torch.ops import cuda_sweep

    a = tt0[b:b + 1].contiguous()
    fx1 = fixed[b:b + 1].contiguous()
    b64 = a.double()
    p32 = cuda_sweep.pack_model(model)
    p64 = cuda_sweep.pack_model(as_float64(model))
    one = np.ones(1, bool)
    out = []
    for k in range(min_passes + polish):
        rep = np.full(1, k >= min_passes)
        a, _, _ = cuda_sweep._launch(a, fx1, p32, rep, one)
        b_new, d64, s64 = cuda_sweep._launch(b64, fx1, p64, rep, one)
        b64 = b_new
        gap = known_gap(a, b64)
        out.append(dict(passes=k + 1, gap=float(gap.max()),
                        delta64=float(d64[0]), scale64=float(s64[0])))
    log("  source %d, float32 against float64 after each pass (gap, float64 "
        "delta), s: %s" % (b, "; ".join(
            f"{r['passes']}{'r' if r['passes'] > min_passes else ''} "
            f"{r['gap']:.2e} {r['delta64']:.2e}" for r in out)))
    z, x = divmod(int(torch.argmax(gap)), a.shape[-1])
    log(f"  after the last pass the gap sits at (z, x) = ({z}, {x}): float64 "
        f"{float(b64[0, z, x]):.9e} s, float32 {float(a[0, z, x]):.9e} s; "
        f"the source's largest time {out[-1]['scale64']:.6e} s")
    return out


def phase_fine_timing(inputs, fine):
    """(e): K1 warm at every stage shape of the fine weld solve (float32)
    beside its bound; at the final shape a float64 pass, then the source
    where it differs most from the float32 pass checked alone against the
    twin and followed pass by pass (k1_fine_vs_twin, gap_by_pass); K2 with the nearest-point tap and with exact
    materials at the weld shape (on the fine fields just solved) against
    their twins and timed beside their bounds; K3 with exact materials
    likewise."""
    from alifmm_tpu_torch import rays, weld_data
    from alifmm_tpu_torch.ops import cuda_sweep

    shapes = []
    for name, model, tt0, fixed in fine_stage_inputs(inputs):
        packed = cuda_sweep.pack_model(model)
        B, Z, X = tt0.shape
        C, G = cuda_sweep.launch_config(B, Z, X, cuda_sweep._sm_count(
            tt0.device))
        n = 3 if Z * X > 1e6 else 10
        ms, _ = time_k1(tt0, fixed, packed, n=n)
        bound, by = bound_ms(tt0, fixed, packed)
        log(f"  {name} ({B} sources) K1 {ms:.4f} ms per pass at C={C} G={G} "
            f"({n} passes); bound {bound:.4f} ms ({by}), share "
            f"{bound / ms:.4f}")
        shapes.append(dict(stage=name, sources=B, cluster=C, lanes=G, ms=ms,
                           bound_ms=bound, bound_by=by))
        if Z * X > 1e6:
            f64 = k1_fine_float64(model, tt0, fixed, packed)
            b = f64["worst_source"]
            shapes[-1].update(float64=f64,
                              vs_twin=k1_fine_vs_twin(model, tt0, fixed, b),
                              gap_by_pass=gap_by_pass(model, tt0, fixed, b))
        del packed, tt0, fixed

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    model, ttfs = inputs[0], fine["ttfs"]
    out = {}
    for key, knobs in (("grid_tap", dict(RAY_OPTS, mode="grid")),
                       ("grid_tap_exact_materials",
                        dict(RAY_OPTS, mode="grid", exact_materials=True))):
        mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
            model, knobs, weld_data.SUBGRID, sx, sy, pairs, dnx)
        args = (model, mat_flat, ttfs, tidx, src, rec, spec, fast)
        ms_twin, want, work = plain_march(args)
        errs = march_vs_twin(args, want, final_cross, torch.float32,
                             f"weld {key} float32")
        k2 = time_march(args, 10)
        k2["plain_ms"] = ms_twin
        bx, by, length = want[:3]
        waves = 2 * RAY_OPTS["relax_iters"]
        bounds = ray_bounds(model, mat_flat, ttfs, spec, work, bx, by,
                            length, final_cross, waves)
        out[key] = dict(march=with_bound(k2, bounds["march"]), errs=errs)
        if mat_flat.shape[1] == 8:
            kw = dict(waves=waves, relax_cross=final_cross,
                      quad=RAY_OPTS["relax_quad"], times_cross=final_cross)
            errs.update(check_k3(model, mat_flat, bx, by, length, spec.s,
                                 final_cross, torch.float32,
                                 f"weld {key} float32", iters=(1,),
                                 single_waves=False))
            out[key]["relax_times"] = with_bound(
                time_k3(model, mat_flat, bx, by, length, spec.s, kw),
                bounds["relax_times"])
    return shapes, out


# --------------------------------------------------------------------- #
# K4, the descent march; the FMC slice with every tracer; device profiles
# --------------------------------------------------------------------- #

# K4 against its twin on 48 x 56: (trace_rays_descent knobs, fine cells
# per model cell, whether the fields lie on the refined grid, model).  The
# facade's descent defaults: step_scale 6, max_cross 16, relax_iters 2,
# relax_quad True, score_k 0.  The slow band bends its rays at row 24.
DESCENT_CASES = {
    "interp, defaults": (dict(), 9, False, "48x56"),
    "interp, score_k 5": (dict(score_k=5), 9, False, "48x56"),
    "grid, defaults": (dict(mode="grid"), 3, True, "48x56"),
    "grid, score_k 5": (dict(mode="grid", score_k=5), 3, True, "48x56"),
    "slow band, defaults": (dict(), 9, False, "slow band"),
    "slow band, score_k 5": (dict(score_k=5), 9, False, "slow band"),
}
# the FMC example's budgets and march knobs (examples/fmc_rays_torch.py)
FMC_SOLVE = dict(final_rel_tol=2e-3, final_polish_passes=3, sweep_block=4)
FMC_RAY_OPTS = dict(max_cross=8, step_scale=6, quad_vel=True, relax_iters=1,
                    relax_quad=3, max_steps=170, cand_stride=6.0)
TRACERS = ("search", "descent", "auto")
# Operations for K4's bound, counted from rays.descent_plain: a step's
# gradient (four loads, 20 operations, a square root and two divides at
# 10 each), its cell (two divides, two roundings, clamps: 30), atan2 20,
# the skew gather 20, cos and sin 40, the stride and the snap (a square
# root, two divides, clamps: 40), about 220; a window candidate's offset
# and clamps 10, its bilinear field sample, its Simpson segment and 5
# material samples (the K2 counts above), about 370; the window's
# minimum search and parabola about 40 a step.
OPS_DESCENT_STEP, OPS_WINDOW_STEP = 220, 40
OPS_WINDOW_CANDIDATE = 10 + OPS_BILINEAR + OPS_SEGMENT + 5 * OPS_SAMPLE
NO_LIBRARY_DESCENT = "no PyTorch call computes a descent march"


def descent_inputs(model, knobs, s, sx, sy, pairs, dnx):
    """(mat_flat, tidx, src_xy, rec_xy, spec, cross) of a descent over
    ``pairs`` with trace_rays_descent's ``knobs``; ``cross`` is the
    crossing budget of its relaxation and times."""
    from alifmm_tpu_torch import rays, weld_data

    kw = dict(max_steps=None, step_scale=6.0, score_k=0, score_stride=1.0,
              mode="interp")
    kw.update({k: v for k, v in knobs.items() if k in kw})
    spec = rays.descent_spec(model, s, **kw)
    _, _, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx, s)
    dev = model.device
    cross = max(knobs.get("max_cross", 16), int(2 * spec.step_scale) + 6)
    return (rays._material_flat(model),
            torch.as_tensor(tidx).to(torch.int64).to(dev),
            torch.as_tensor(src_xy).to(model.dtype).to(dev),
            torch.as_tensor(rec_xy).to(model.dtype).to(dev), spec, cross)


def descent_vs_twin(args, want, cross, dtype, what):
    """K4 as a bare launch and through the wrapper
    ``cuda_rays.march_descent`` against the twin's result ``want``: equal
    in every vertex, length, reason and step count, in both types.
    Returns the differences by key."""
    from alifmm_tpu_torch.ops import cuda_rays

    model, mat_flat, spec = args[0], args[1], args[6]
    runs = []
    for shared, fast in ((True, True), (False, True), (True, False)):
        p = cuda_rays.prepare_march_descent(*args, shared=shared, fast=fast)
        p.run()
        where = "shared" if p.plan["tables_smem"] else "device"
        runs.append((f"bare, tables in {where} memory"
                     + ("" if fast else ", every step exact"), p.out))
    runs.append(("through the wrapper", cuda_rays.march_descent(*args)))
    torch.cuda.synchronize()
    vertex, equal = 0.0, 1.0
    for how, got in runs:
        v, e = compare_march(got, want, model, mat_flat, spec.s, cross,
                             dtype, f"K4 {what}, {how}")
        vertex, equal = max(vertex, v), min(equal, e)
    # K4 follows the twin operation for operation, in both types
    check(vertex == 0.0 and equal == 1.0,
          f"K4 {what}: not equal to its twin ray for ray")
    return dict(descent=vertex, descent_unequal=1.0 - equal)


def check_trace_descent(args, knobs, cross, dtype, what):
    """``rays.trace_rays_descent`` on the card: one K4 and one K3 launch
    and no plain step; its lengths and reasons are K4's, and its polylines
    and times equal K3's twin (``relax_and_times_plain``, the waves and
    crossing budget the tracer states) run on K4's polylines, within the
    relaxation's tolerance.  Returns the differences by key."""
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    model, mat_flat, fields, tidx, src, rec, spec = args
    before, steps0 = dict(cuda_rays.LAUNCHES), rays.PLAIN_STEPS
    got = rays.trace_rays_descent(model, fields, tidx, src, rec, spec.s,
                                  return_reason=True, **knobs)
    torch.cuda.synchronize()
    launched = {k: cuda_rays.LAUNCHES[k] - before[k] for k in before}
    check(launched["descent"] == 1 and launched["relax_times"] == 1
          and launched["march"] == 0 and rays.PLAIN_STEPS == steps0,
          f"trace_rays_descent {what} launched {launched}")
    p = cuda_rays.prepare_march_descent(*args)
    p.run()
    bx, by, length, reason, _ = p.out
    check(torch.equal(got[2], length) and torch.equal(got[4], reason),
          f"trace_rays_descent {what}: lengths or reasons are not K4's")
    wx, wy, wt = rays.relax_and_times_plain(
        model, mat_flat, bx, by, length, spec.s,
        2 * knobs.get("relax_iters", 2), relax_cross=cross,
        quad=knobs.get("relax_quad", True), times_cross=cross)
    torch.cuda.synchronize()
    ax, rx = worst_rel(got[0], wx)
    ay, ry = worst_rel(got[1], wy)
    at, rt = worst_rel(got[3], wt)
    log(f"  trace_rays_descent {what}: launches {launched['descent']} K4, "
        f"{launched['relax_times']} K3; against K3's twin on K4's "
        f"polylines: vertices max rel {max(rx, ry):.3e}, times max abs "
        f"{at:.3e} s, max rel {rt:.3e} (tolerance {TOL_SEG[dtype]:.0e})")
    check(max(rx, ry, rt) <= TOL_SEG[dtype],
          f"trace_rays_descent {what} differs from its composed twin")
    return dict(relax_vertices=max(ax, ay), relax_times=at,
                relax_times_rel=rt)


def descent_case(case, dtype, device):
    """The inputs of one case of DESCENT_CASES (25 rays through 5 fields
    solved on the card, on the refined grid for the grid cases): (args of
    ``prepare_march_descent``, knobs, crossing budget)."""
    from alifmm_tpu_torch import solver, weld_data

    knobs, s, fine, model_name = DESCENT_CASES[case]
    model = (small_model(dtype, device) if model_name == "48x56"
             else slow_band_model(dtype, device))
    dnx = float(model.dnx)
    sx, sy, pairs = weld_data.transducers(model.shape, dnx, 5, 10)
    scx, scz = weld_data.ray_pairs(sx, sy, pairs, dnx)[:2]
    ttfs = solver.solve_ttf(model, torch.as_tensor(scx), torch.as_tensor(scz),
                            s if fine else 1, solver.SolveConfig(**SOLVE_KW))
    mat_flat, tidx, src, rec, spec, cross = descent_inputs(
        model, knobs, s, sx, sy, pairs, dnx)
    return (model, mat_flat, ttfs, tidx, src, rec, spec), knobs, cross


def check_descent(case, dtype, device):
    """One case of DESCENT_CASES on 48 x 56: K4 against descent_plain,
    then trace_rays_descent; in float32 also the profiling build's
    split.  Returns the largest differences by key."""
    from alifmm_tpu_torch import rays

    args, knobs, cross = descent_case(case, dtype, device)
    want = rays.descent_plain(*args)
    what = f"48x56 {case} {str(dtype).replace('torch.', '')}"
    errs = descent_vs_twin(args, want, cross, dtype, what)
    merge_worst(errs, check_trace_descent(args, knobs, cross, dtype, what))
    if dtype == torch.float32:
        log_profile(descent_profile(args, want))
    return errs


def phase_descent_vs_plain(device):
    """(4c): every case of DESCENT_CASES in float64 and float32."""
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for case in DESCENT_CASES:
            merge_worst(worst, check_descent(case, dtype, device))
    return worst


def descent_bound(fields, mat_flat, model, spec, steps, P):
    """K4's bound for this run's rays.  Operations from the steps the
    twin took (``steps``): OPS_DESCENT_STEP a step, and with the window
    OPS_WINDOW_STEP plus score_k x OPS_WINDOW_CANDIDATE.  Bytes, each
    counted once: the field cells its bilinear samples read (4 a sample,
    one sample a step and one a candidate, at most the stack), the
    material rows its cells and Simpson samples read (at most all rows),
    the skew table (and with the window the curve table), the rays'
    inputs and its outputs."""
    R = steps.shape[0]
    n_steps = int(steps.sum())
    K = spec.score_k
    item = fields.element_size()
    ops = n_steps * (OPS_DESCENT_STEP
                     + (OPS_WINDOW_STEP + K * OPS_WINDOW_CANDIDATE if K
                        else 0))
    tables = model.ray_skew.numel() + (model.ray_curves.numel() if K else 0)
    nbytes = (min(fields.numel(), n_steps * 4 * (1 + K)) * item
              + min(mat_flat.shape[0], n_steps * (1 + 5 * K))
              * mat_flat.shape[1] * item
              + tables * item + (4 * R + 2 * R * P) * item + 4 * R * 8)
    log(f"  K4 bound: {n_steps} steps, {nbytes / 1e6:.3f} MB and "
        f"{ops / 1e9:.4f} Gop")
    return roofline(ops, nbytes)


def descent_profile(args, out, fast=True):
    """K4's clock64 build (float32) on ``args``: it must march as the
    launch whose outputs are ``out``.  Returns the longest ray's step
    split by part (shares of its cycles), its cycles a step, and over all
    rays the shares of the steps and of the window's pieces that ran again
    exactly (an operand outside the fast paths' range)."""
    from alifmm_tpu_torch.ops import cuda_rays

    pp = cuda_rays.prepare_march_descent(*args, fast=fast, profile=True)
    pp.run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(pp.out[:5], out)),
          "K4's profiling build marched otherwise")
    cols = dict(zip(cuda_rays.DESCENT_PROFILE, pp.out[5].double().T))
    longest = int(torch.argmax(out[4]))
    parts = cuda_rays.DESCENT_PARTS
    cyc = torch.stack([cols[k][longest] for k in parts])
    total = float(cyc.sum())
    pieces = float(cols["window_pieces"].sum())
    n_steps = float(out[4].sum())
    return dict(
        split={k: float(c) / total for k, c in zip(parts, cyc)},
        cycles_per_step=total / float(out[4][longest]),
        exact_step_share=float(cols["exact_steps"].sum()) / n_steps,
        exact_piece_share=(float(cols["exact_pieces"].sum()) / pieces
                           if pieces else None))


def log_profile(prof, us=None):
    """One line of descent_profile's result; ``us``: the bare time a step,
    to give the parts in us."""
    win = prof["exact_piece_share"]
    log("    step split of the longest ray (clock64): "
        + ", ".join(f"{k} {v:.3f}" + ("" if us is None else
                                      f" ({us * v:.3f} us)")
                    for k, v in prof["split"].items())
        + f"; {prof['cycles_per_step']:.0f} cycles a step; run again "
        f"exactly: steps "
        f"{prof['exact_step_share']:.4f}, window pieces "
        + ("-" if win is None else f"{win:.4f}"))


def time_descent(args, want, ms_twin, n=10):
    """K4 on ``args`` warm: the bare launch with its outputs allocated
    beforehand and the call through its wrapper (CUDA events over n
    calls), the longest ray's dependent steps and the time a step, beside
    its bound (from the twin's run ``want``) and the twin's time; in
    float32 also the step split of the profiling build."""
    from alifmm_tpu_torch.ops import cuda_rays

    model, mat_flat, fields, spec = args[0], args[1], args[2], args[6]
    p = cuda_rays.prepare_march_descent(*args)
    bare = time_events(p.run, n)
    wrapper = time_events(lambda: cuda_rays.march_descent(*args), n)
    steps = p.out[4]
    chain = int(steps.max())
    us = bare * 1e3 / chain
    warps = cuda_rays.occupancy(p, spec.score_k, model.dtype) * 4
    clock = sm_clock()
    log(f"  K4 (SM clock {clock}) {bare:.4f} ms bare, {wrapper:.4f} ms "
        f"through the wrapper, for "
        f"{args[3].shape[0]} rays (score_k {spec.score_k}, "
        f"{p.plan['lanes']} lanes a ray, {p.plan['smem']} B of shared "
        f"memory a block, {warps} warps resident per SM, max_steps "
        f"{spec.max_steps}); the longest ray takes {chain} dependent steps: "
        f"{us:.3f} us a step; all rays {int(steps.sum())} steps; twin "
        f"{ms_twin:.1f} ms")
    timed = dict(ms=bare, wrapper_ms=wrapper, chain=chain, us_per_step=us,
                 steps=int(steps.sum()), plain_ms=ms_twin,
                 rays=int(args[3].shape[0]), score_k=spec.score_k,
                 lanes=p.plan["lanes"], warps_per_sm=warps, sm_clock=clock)
    if model.dtype == torch.float32:
        prof = descent_profile(args, p.out)
        log_profile(prof, us)
        timed["profile"] = prof
    b, by_what = descent_bound(fields, mat_flat, model, spec, want[4],
                               want[0].shape[1])
    timed.update(bound_ms=b, bound_by=by_what, share=b / bare)
    log(f"    bound {b:.5f} ms ({by_what}), share of the bare time "
        f"{b / bare:.4f}; library call: none ({NO_LIBRARY_DESCENT})")
    return timed


def descent_at_shape(model, fields, geometry, knobs, s, dtype, worst, what,
                     timed=True):
    """K4 on these fields against its twin (bare and through the wrapper),
    trace_rays_descent against its composed twin, and (``timed``) K4
    timed beside its bound and the twin.  The differences go into
    ``worst``."""
    from alifmm_tpu_torch import rays

    mat_flat, tidx, src, rec, spec, cross = descent_inputs(
        model, knobs, s, *geometry)
    args = (model, mat_flat, fields, tidx, src, rec, spec)
    ms_twin, want = time_host(lambda: rays.descent_plain(*args))
    merge_worst(worst, descent_vs_twin(args, want, cross, dtype, what))
    merge_worst(worst, check_trace_descent(args, knobs, cross, dtype, what))
    return time_descent(args, want, ms_twin) if timed else None


def phase_descent_weld(inputs, ttfs, worst, device):
    """(7b): K4 at the weld shape (961 rays through the 31 model-grid
    fields of phase 6), the facade's descent defaults and score_k 5, in
    float64 and float32 against its twin; timed in float32."""
    from alifmm_tpu_torch import weld_data

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    out = {}
    for dtype in (torch.float64, torch.float32):
        model = (inputs[0] if dtype == torch.float32
                 else ray_model("weld", dtype, device))
        for k in (0, 5):
            t = descent_at_shape(
                model, ttfs.to(dtype), (sx, sy, pairs, dnx),
                dict(score_k=k), weld_data.SUBGRID, dtype, worst,
                f"weld score_k {k} {str(dtype)[6:]}",
                timed=dtype == torch.float32)
            if t is not None:
                out[f"score_k {k}"] = t
    return out


def phase_descent_fine(inputs, fine, worst):
    """(10b): K4 in grid mode at the weld shape, on the fine fields of
    phase 9 (31 x 3808 x 4492), score_k 0 and 5: float32 against its twin
    and timed, float64 (a 4.2 GB copy of the fields) against its twin."""
    from alifmm_tpu_torch import weld_data

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    geometry = (sx, sy, pairs, dnx)
    out = {}
    for k in (0, 5):
        out[f"score_k {k}"] = descent_at_shape(
            inputs[0], fine["ttfs"], geometry, dict(mode="grid", score_k=k),
            weld_data.SUBGRID, torch.float32, worst,
            f"fine weld grid score_k {k} float32")
    model64 = ray_model("weld", torch.float64, inputs[0].device)
    fields64 = fine["ttfs"].double()
    for k in (0, 5):
        descent_at_shape(model64, fields64, geometry,
                         dict(mode="grid", score_k=k), weld_data.SUBGRID,
                         torch.float64, worst,
                         f"fine weld grid score_k {k} float64", timed=False)
    del fields64
    return out


def fmc_geometry():
    """The FMC workload: the weld of weld_data.workload(0) with every pair
    of its 62 transducers (the upper triangle): 61 receivers, 1891 rays."""
    from alifmm_tpu_torch import weld_data

    veln, velpn, vel_map, stif, sx, sy, _, dnx = weld_data.workload(0)
    n = len(sx)
    return (veln, velpn, vel_map, stif, sx, sy,
            np.triu(np.ones((n, n)), k=1), dnx)


def routed_knobs(tracer):
    """The knobs the facade passes to ``tracer`` for FMC_RAY_OPTS."""
    import warnings

    import alifmm_tpu_torch

    fn = alifmm_tpu_torch.api._TRACERS[tracer]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return alifmm_tpu_torch.ALI_FMM._route_ray_opts(
            tracer, fn, dict(FMC_RAY_OPTS))


def expected_launches(tracer, retraced):
    """Kernel launches of one trace: auto adds one K2 and one K3 when the
    certificate flags any ray (``retraced``)."""
    n = int(bool(retraced))
    return {"search": dict(march=1, relax_times=1, descent=0),
            "descent": dict(march=0, relax_times=1, descent=1),
            "auto": dict(march=n, relax_times=1 + n, descent=1)}[tracer]


def check_tracer_counts(counts, tracer, retraced, what):
    want = expected_launches(tracer, retraced)
    check(counts["sweep_pass"] > 0, f"{what} launched no sweep_pass kernel")
    for name, n in want.items():
        check(counts[name] == n,
              f"{what} launched {counts[name]} {name} kernels, not {n}")
    check(counts["plain_passes"] == 0 and counts["plain_steps"] == 0,
          f"{what} ran a plain twin on the card")


def phase_fmc(device):
    """(11): the FMC slice (61 fields of 424 x 500, 1891 rays, float32)
    with each tracer, directly (solve_ttf, then the tracer with the knobs
    the facade routes to it; a warm-up run, then a timed one with every
    count set to 0 just before it) and through ALI_FMM (a warm-up call,
    then a timed one likewise); K4 timed on the FMC fields."""
    import warnings

    import alifmm_tpu_torch
    from alifmm_tpu_torch import grid, rays, solver, weld_data

    alifmm_tpu_torch.tqdm_disable = True
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = fmc_geometry()
    s = weld_data.SUBGRID
    model = grid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                            dtype=torch.float32, device=device)
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx)
    n_rays = len(tidx)
    check(len(scx) == 61 and n_rays == 1891,
          f"FMC geometry: {len(scx)} receivers, {n_rays} rays")

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a).to(dt).to(device)

    scx_d, scz_d, src, rec = dev(scx), dev(scz), dev(src_xy), dev(rec_xy)
    tidx_d = dev(tidx, torch.int64)
    fns = {"search": rays.trace_rays, "descent": rays.trace_rays_descent,
           "auto": rays.trace_rays_auto}
    cfg = solver.SolveConfig(**FMC_SOLVE)

    def run(tracer):
        # the search and descent marches say why each ray ended
        extra = {} if tracer == "auto" else dict(return_reason=True)
        t0 = time.perf_counter()
        ttfs = solver.solve_ttf(model, scx_d, scz_d, 1, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fns[tracer](model, ttfs, tidx_d, src, rec, s, mode="interp",
                          **routed_knobs(tracer), **extra)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return ttfs, out, (t1 - t0, t2 - t1, t2 - t0)

    res, times, lens, ok = {}, {}, {}, {}
    ttfs = None
    for tracer in TRACERS:
        run(tracer)
        reset_counts()
        ttfs, out, (t_solve, t_rays, wall) = run(tracer)
        counts = read_counts()
        lens[tracer], times[tracer] = out[2], out[3]
        if tracer != "auto":
            # arrived: ended for reason 0 within the step budget (the
            # relaxation may move the last marched vertex afterwards)
            budget = routed_knobs(tracer)["max_steps"]
            ok[tracer] = (out[4] == 0) & (out[2] - 2 < budget)
        else:
            # a ray the certificate kept is the descent's; a retraced one
            # is the search's, the same march on the same inputs
            kept = out[3] == times["descent"]
            same = torch.where(kept, out[2] == lens["descent"],
                               (out[2] == lens["search"])
                               & (out[3] == times["search"]))
            check(bool(same.all()), f"FMC auto: {int((~same).sum())} rays "
                  f"are neither the descent's nor the search's")
            ok[tracer] = torch.where(kept, ok["descent"], ok["search"])
        t = times[tracer]
        fin = torch.isfinite(t) & (t > 0)
        log(f"  FMC direct, tracer {tracer}: warm wall clock {wall:.4f} s "
            f"(solve {t_solve:.4f} s, rays {t_rays:.4f} s); "
            f"{int(ok[tracer].sum())} of {n_rays} rays arrive, "
            f"{int(fin.sum())} finite positive times; steps max "
            f"{int(out[2].max()) - 2}; counts {counts}")
        check(bool(ok[tracer].all()) and bool(fin.all()),
              f"FMC {tracer}: {n_rays - int(ok[tracer].sum())} rays did not "
              f"arrive, {n_rays - int(fin.sum())} times not finite and "
              f"positive")
        res[tracer] = dict(wall=wall, solve=t_solve, rays=t_rays,
                           counts=counts)
    # the certificate of the auto tracer, as trace_rays_auto computes it
    tol = routed_knobs("auto").get("tol", 3e-3)
    t_true = rays._sample_ttf(ttfs, src[:, 0], src[:, 1], s, "interp",
                              tidx_d)
    flagged = int((~(times["descent"] <= (1.0 + tol) * t_true)).sum())
    for tracer in TRACERS:
        check_tracer_counts(res[tracer]["counts"], tracer, flagged,
                            f"FMC direct {tracer}")
    above = int((times["auto"] > times["descent"]).sum())
    check(above == 0, f"FMC: {above} auto times above their descent times")
    gaps = {}
    for tracer in ("descent", "auto"):
        rel = ((times[tracer].double() - times["search"].double())
               / times["search"].double())
        gaps[tracer] = dict(median=float(rel.median()),
                            max=float(rel.abs().max()),
                            min=float(rel.min()))
        log(f"  FMC {tracer} times against search times: relative "
            f"difference median {gaps[tracer]['median']:.4e}, max |.| "
            f"{gaps[tracer]['max']:.4e}, min {gaps[tracer]['min']:.4e}")
    log(f"  FMC auto: {flagged} of {n_rays} rays flagged by the certificate "
        f"(tol {tol}), retraced in one K2 and one K3 launch; auto's ray "
        f"phase {res['auto']['rays']:.4f} s against the descent's "
        f"{res['descent']['rays']:.4f} s")

    for tracer in TRACERS:
        fm = alifmm_tpu_torch.ALI_FMM(
            veln, velpn, vel_map, sx, sy, stif_den=stif, dnx=dnx,
            ttf_mode="interp", solve_opts=FMC_SOLVE,
            ray_opts=dict(FMC_RAY_OPTS, tracer=tracer))

        def call():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                tmat = fm.find_all_TTF_rays_parallel(
                    veln, velpn, vel_map, stif_den=stif, n_threads=8,
                    subgrid_size=s)
                torch.cuda.synchronize()
                return tmat, time.perf_counter() - t0

        call()
        reset_counts()
        tmat, wall = call()
        counts = read_counts()
        check_tracer_counts(counts, tracer, flagged, f"FMC facade {tracer}")
        traced = np.triu(np.ones((len(sx), len(sx)), bool), k=1)
        check(bool(np.isfinite(tmat).all()) and bool((tmat[traced] > 0).all())
              and not tmat[~traced].any(),
              f"FMC facade {tracer}: time matrix not positive on exactly "
              f"the {n_rays} pairs")
        check(np.array_equal(fm.ray_len > 0, traced),
              f"FMC facade {tracer}: ray_len not positive on the pairs")
        # the facade's rays are the direct path's (the same lengths and
        # times), which all arrived
        pi, pj = np.nonzero(traced)
        direct = times[tracer].double().cpu().numpy()
        rel = float((np.abs(tmat[pi, pj] - direct) / direct).max())
        same_len = np.array_equal(fm.ray_len[pi, pj],
                                  lens[tracer].cpu().numpy())
        log(f"  FMC facade, tracer {tracer}: warm call {wall:.4f} s; ray "
            f"lengths {'equal' if same_len else 'not equal'} to the direct "
            f"path's, times against its max rel {rel:.3e}; counts {counts}")
        check(same_len and rel <= 1e-6, f"FMC facade {tracer}: rays differ "
              f"from the direct path's")
        res[tracer].update(facade_wall=wall, facade_counts=counts)

    # K4 on the FMC fields: the facade's descent defaults and score_k 5
    worst = {}
    k4 = {}
    for k in (0, 5):
        k4[f"score_k {k}"] = descent_at_shape(
            model, ttfs, (sx, sy, pairs, dnx), dict(score_k=k), s,
            torch.float32, worst, f"FMC score_k {k} float32")
    return dict(tracers=res, gaps=gaps, flagged=flagged, k4=k4, worst=worst)


def busy_share(path):
    """From a Chrome trace of torch.profiler: the share of the traced span
    in which a kernel, copy or fill ran on the device (overlaps counted
    once), the number of such device events, and the five kernels with
    the most device time (ms).  (None, 0, []) without device events."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "")) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        return None, 0, []
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, -np.inf
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / (t1 - t0), len(dev), [(n[:80], ms) for n, ms in top]


def phase_profiles(inputs, device):
    """(12): one utils/profiling.trace each of a warm weld slice (phase
    6's direct path) and a warm FMC slice with the descent tracer, and
    the device's busy share in each."""
    import shutil
    import tempfile

    from alifmm_tpu_torch import rays, solver, weld_data
    from alifmm_tpu_torch.utils import profiling

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = fmc_geometry()
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs, dnx)
    model = inputs[0]

    def fmc_descent():
        ttfs = solver.solve_ttf(
            model, torch.as_tensor(scx).float().to(device),
            torch.as_tensor(scz).float().to(device), 1,
            solver.SolveConfig(**FMC_SOLVE))
        rays.trace_rays_descent(
            model, ttfs, torch.as_tensor(tidx).to(device),
            torch.as_tensor(src_xy).float().to(device),
            torch.as_tensor(rec_xy).float().to(device), weld_data.SUBGRID,
            mode="interp", **routed_knobs("descent"))

    out = {}
    for name, fn in (("weld slice", lambda: run_slice(inputs)),
                     ("FMC slice, descent", fmc_descent)):
        fn()
        torch.cuda.synchronize()
        log_dir = tempfile.mkdtemp(prefix="alifmm_trace_")
        try:
            t0 = time.perf_counter()
            with profiling.trace(log_dir):
                fn()
            wall = time.perf_counter() - t0
            share, n_dev, top = busy_share(
                os.path.join(log_dir, profiling.TRACE_FILE))
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        if share is None:
            log(f"  profile of the {name}: no device events in the trace "
                f"(busy share not measured)")
        else:
            log(f"  profile of the {name}: {wall:.4f} s under the profiler, "
                f"{n_dev} device events, busy share {share:.4f}; most device "
                f"time: " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top))
        out[name] = dict(busy_share=share, device_events=n_dev,
                         profiled_wall=wall, top=top)
    return out


# --------------------------------------------------------------------- #
# Shear modes: qSV tables, K1's interpolated table lookup, the qSV weld
# --------------------------------------------------------------------- #

# The weld's one stiffness row (bench_data/weld_stif_den.npy, MPa) in Pa,
# and the parent metal's shear speed, a mild steel's (weld_data's qP speed
# there is 5790 m/s)
QSV_STIFF = (263e9, 148e9, 216e9, 129e9, 8100.0)
PARENT_SHEAR = 3240.0
# tests/test_qsv_mode.py's austenite and its bounds on homogeneous 33 x 37
# media: mean and max, at >= 6 and >= 4 degrees from a wavefront corner,
# the earliest arrival, the point asymmetry
QSV_HOMOG_STIFF = (263e9, 145e9, 216e9, 129e9, 7800.0)
QSV_MEAN, QSV_MAX, QSV_SMOOTH, QSV_NEAR = 1.2e-2, 9.5e-2, 1.2e-2, 3.2e-2
QSV_EARLIEST, QSV_ASYM = -2e-2, 1.5e-2
# each qSV ray time against the same pair's qP time (phase 6): every shear
# speed is at most 3240 m/s and every qP speed at least 5164 m/s (a first
# arrival at least 1.59x later), and 6329 / 2358 = 2.68
QSV_OVER_QP = (1.5, 2.8)
# tests/test_analytic_truth.py's accuracy-preset bounds (max, mean)
ACCURACY_ISO = (2.4e-2, 1.5e-2)
ACCURACY_QP = (4.5e-2, 1.6e-2)


# qSH (phase 15): the SH pair of QSV_STIFF with c66 as
# tests/test_torch_modes.py takes it.  Its phase speed sqrt((cos^2 c66 +
# sin^2 c44) / rho) is an ellipse, so each qSH ray time against the same
# pair's qP time lies between 5164 / 3991 = 1.29 and 6329 / 3240 = 1.95
# (qSH speeds 3240, the parent, to 3991 m/s; qP speeds 5164-6329 m/s)
QSH_C66 = 98e9
QSH_OVER_QP = (1.25, 2.0)
# The qSH weld's rays that do not arrive (15c), those the JAX package does
# not land on the same fields either (tests/qsv_ray_records.py on the
# rays 15c saves): with the weld's knobs the plane search stops on 19
# rays to the last bottom receivers when the time along them starts to
# rise (reason 2), after 3-29 vertices, at JAX's vertices; with
# the defaults the descent runs out of its 770 steps on 20 of 21 rays, the
# search stops on all 21, and auto keeps the search's rays, ray 937 too,
# which the descent lands
QSH_SEARCH_EARLY = (789, 790, 819, 820, 821, 850, 851, 852, 872, 881, 882,
                    883, 912, 913, 914, 934, 943, 944, 945)
QSH_AUTO_LOST = tuple(sorted(QSH_SEARCH_EARLY + (903, 937)))
# (15d) homogeneous qSH against its closed-form first arrival: 424 x 500,
# dnx 2e-4, orientation 0, one interior source (row, column)
QSH_SHAPE, QSH_DNX, QSH_SOURCE = (424, 500), 2e-4, (212, 250)
# tests/qsh_records.py: the JAX package's error on that model against the
# closed-form time in float64 (max, mean; 239 s on 8 cores), and the
# float32 margin: the float32 record moved them by -7.3e-5 and -6.5e-7
QSH_JAX_ERROR = (2.356133e-2, 5.526133e-3)
QSH_F32_MARGIN = (1e-4, 1e-6)


def qsv_tables(stiff=QSV_STIFF, mode="qSV"):
    """(group, phase) tables of the shear models: column 0 the angle,
    column 1 ones (the isotropic parent metal, scaled by vel_map), column 2
    the first-arrival pair of ``materials.generate_mode_curves`` for
    ``mode`` (qSH with c66 = QSH_C66)."""
    from alifmm_tpu_torch import materials

    c66 = QSH_C66 if mode == "qSH" else None
    g, p = materials.generate_mode_curves(*stiff, c66=c66, mode=mode)
    ang, one = np.arange(361.0), np.ones(361)
    return np.stack([ang, one, g], 1), np.stack([ang, one, p], 1)


def qsv_weld_arrays():
    """(veln, velpn, vel_map) of the qSV weld: weld_data's seeded layout and
    orientations; in the weld velpn 2 (the qSV column) and vel_map 1, in
    the parent metal velpn 1 and vel_map PARENT_SHEAR; no stiffness."""
    from alifmm_tpu_torch import weld_data

    veln, velpn, _, _ = weld_data.weld_model_arrays(0)
    weld = velpn == 0
    return veln, np.where(weld, 2, 1), np.where(weld, 1.0, PARENT_SHEAR)


def qsv_weld_model(dtype, device, mode="qSV"):
    """The qSV weld's layout with ``mode``'s pair as column 2."""
    from alifmm_tpu_torch import grid, weld_data

    g, p = qsv_tables(mode=mode)
    return grid.make_model(*qsv_weld_arrays(), None, g, p, weld_data.DNX,
                           dtype=dtype, device=device)


def qsh_homogeneous_arrays():
    """(veln, velpn, vel_map) of 15d's model: orientation 0, the qSH column
    everywhere."""
    Z, X = QSH_SHAPE
    return np.zeros((Z, X)), np.full((Z, X), 2), np.ones((Z, X))


def qsh_homogeneous_time(stiff=QSV_STIFF):
    """The closed-form qSH first arrival on 15d's model from QSH_SOURCE: t
    = sqrt((x / v0)^2 + (z / v90)^2), v0 = sqrt(c66 / rho) along x (the
    tables' angle 0) and v90 = sqrt(c44 / rho) along z."""
    c44, rho = stiff[3], stiff[4]
    v0, v90 = np.sqrt(QSH_C66 / rho), np.sqrt(c44 / rho)
    Z, X = QSH_SHAPE
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    sz, sx = QSH_SOURCE
    return np.hypot((xx - sx) * QSH_DNX / v0, (zz - sz) * QSH_DNX / v90)


def qsh_errors(field, want):
    """(max, mean) relative error of a field against the closed-form time,
    over every point but the source."""
    mask = want > 0
    rel = np.abs(np.asarray(field, np.float64) - want)[mask] / want[mask]
    return float(rel.max()), float(rel.mean())


def qsv_random_model(Z, X, dtype, device, seed=0):
    """random_model's layout with its stiffness block a qSV table column
    (velpn 2) and the rest the isotropic column at PARENT_SHEAR."""
    from alifmm_tpu_torch import grid

    rng = np.random.default_rng(seed)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.ones((Z, X), dtype=int)
    velpn[Z // 4: 3 * Z // 4, 2 * X // 7: 5 * X // 7] = 2
    vel_map = np.where(velpn == 1, PARENT_SHEAR, 1.0)
    g, p = qsv_tables()
    return grid.make_model(veln, velpn, vel_map, None, g, p, 2e-4,
                           dtype=dtype, device=device)


def _qsv_seeded(dtype, device):
    model = qsv_random_model(48, 56, dtype, device)
    return (model, *seeded(model.shape, 3, dtype, device))


# K1's interpolated lookup (column mode 2) against its twin, at the AUTO
# launch shapes
QSV_PASS_CASES = {
    "qSV 48x56": _qsv_seeded,
    "qSV weld patches 109x109": lambda dt, dev: weld_patches(
        2, 27, dt, dev, qsv_weld_model(dt, dev)),
    "qSV weld patches 79x79": lambda dt, dev: weld_patches(
        13, 3, dt, dev, qsv_weld_model(dt, dev)),
}


def check_qsv_fixpoint(dtype, device):
    """The two-phase fixpoint under for_mode("qsv")'s final-stage budget
    (96 phase-1 passes, 8 to 96 polish passes) on qSV 48 x 56 through K1,
    against the same loop over the graphed twin; in float64 the pass
    counts must be equal.  Returns the largest absolute difference."""
    from alifmm_tpu_torch import solver
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    model = qsv_random_model(48, 56, dtype, device)
    tt, fixed = seeded(model.shape, 3, dtype, device)
    cfg = solver.SolveConfig.for_mode("qsv")
    kw = dict(rel_tol=cfg.rel_tol, max_passes=cfg.final_max_passes,
              min_passes=2, polish_passes=cfg.final_polish_passes,
              max_polish_passes=cfg.final_max_polish)
    got, info_k = cuda_sweep.solve_fixpoint(tt, model, fixed, **kw)

    def graphed(t, rep, act):
        return sweep.plain_pass(t, model, fixed, rep, act, graphed=True)

    want, info_p = sweep.two_phase(tt, graphed, False, **kw)
    name = str(dtype).replace("torch.", "")
    abs_e, rel_e = rel_err(got, want)
    log(f"  qSV 48x56 solve_fixpoint (for_mode('qsv')) {name}: max abs "
        f"{abs_e:.3e} max rel {rel_e:.3e} (tolerance "
        f"{TOL_SOLVE[dtype]:.0e}); passes kernel {info_k.passes} "
        f"(converged {info_k.converged}), graphed twin {info_p.passes}")
    check(rel_e <= TOL_SOLVE[dtype], f"qSV solve_fixpoint {name} differs")
    if dtype == torch.float64:
        check(info_k == info_p,
              "qSV solve_fixpoint float64 pass counts differ")
    return abs_e


def phase_qsv_kernel(device):
    """(11a): QSV_PASS_CASES in float64 and float32, the qSV fixpoint in
    float64 (where the pass counts must agree)."""
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for name in QSV_PASS_CASES:
            worst = max(worst, check_qsv_case(name, dtype, device))
    return max(worst, check_qsv_fixpoint(torch.float64, device))


def phase_qsv_homogeneous(device):
    """(11b): tests/test_qsv_mode.py's homogeneous 33 x 37 cases on the
    card in float64, veln 140 and 0, with the full stage schedule and
    for_mode("qsv"), held to that file's bounds against the hull arrival
    t = d / v_hull(veln - ray angle) (its qSV tables as column 2 of
    ``qsv_tables``)."""
    from alifmm_tpu_torch import grid, materials, solver

    Z, X, dnx = 33, 37, 5e-4
    gtab, ptab = qsv_tables(QSV_HOMOG_STIFF)
    g = gtab[:, 2]
    corners = np.unique(np.mod(materials.wavefront_corner_angles(
        *QSV_HOMOG_STIFF, mode="qSV"), 180.0))
    check(len(corners) > 0, "qSV: no wavefront corners")
    sz, sx = 16, 18
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    dz, dx = zz - sz, xx - sx
    ang = np.where(dx == 0, 90.0, np.degrees(
        np.arctan(dz / np.where(dx == 0, 1, dx))))
    out = {}
    for veln0 in (140.0, 0.0):
        model = grid.make_model(
            veln0 * np.ones((Z, X)), np.full((Z, X), 2), np.ones((Z, X)),
            None, gtab, ptab, dnx, dtype=torch.float64, device=device)
        tt, info = solver.solve_ttf(
            model, np.array([sx * dnx]), np.array([sz * dnx]), 1,
            solver.SolveConfig.for_mode("qsv"), return_info=True)
        got = tt[0].cpu().numpy()
        eff = np.mod(veln0 - ang, 180.0)
        lo = np.floor(eff).astype(int)
        fr = eff - lo
        vh = g[lo] * (1 - fr) + g[np.minimum(lo + 1, 360)] * fr
        want = dnx * np.hypot(dz, dx) / vh
        mask = want > 0
        safe = np.where(mask, want, 1.0)
        relf = np.abs(got - want) / safe
        rel = relf[mask]
        early = ((got - want) / safe)[mask].min()
        asym = (np.abs(got - got[::-1, ::-1]) / safe)[mask].max()
        cd = np.min(np.stack([
            np.minimum(np.mod(eff - c, 180.0), 180.0 - np.mod(eff - c, 180.0))
            for c in corners]), axis=0)
        smooth = relf[mask & (cd >= 6.0)].max()
        near = relf[mask & (cd >= 4.0)].max()
        big = mask & (relf > QSV_NEAR)
        r = dict(mean=float(rel.mean()), max=float(rel.max()),
                 smooth=float(smooth), near=float(near), earliest=float(early),
                 asymmetry=float(asym), passes=info.passes,
                 converged=info.converged)
        log(f"  qSV homogeneous 33x37, veln {veln0:g}: rel err mean "
            f"{r['mean']:.4e} max {r['max']:.4e}; >= 6 deg from a corner "
            f"{smooth:.4e}, >= 4 deg {near:.4e}; earliest {early:.4e}; "
            f"asymmetry {asym:.4e}; final passes {info.passes} converged "
            f"{info.converged}")
        check(r["mean"] < QSV_MEAN and r["max"] < QSV_MAX
              and smooth < QSV_SMOOTH and near < QSV_NEAR
              and bool(np.all(cd[big] < 4.0)) and early > QSV_EARLIEST
              and asym < QSV_ASYM,
              f"qSV homogeneous veln {veln0:g}: out of test_qsv_mode's "
              f"bounds")
        check(info.converged and info.passes < 96,
              f"qSV homogeneous veln {veln0:g}: not converged in 96 passes")
        out[f"veln {veln0:g}"] = r
    return out


def qsv_search_ends(out, rec_xy, what, edge_rule=True):
    """How the plane search's rays end on the qSV weld: every time finite
    and positive, and every ray arrived within the step budget or finished
    early because its next plane left the grid (reason 1: the reference's
    rule, Anis_TTF_rays.py:3172, :3294; the receiver is appended) with its
    last marched vertex within two steps of its receiver.  The JAX package
    finishes ray 262 (top transducer 8 to bottom transducer 14) so, one
    step and a half from its receiver on the bottom edge, at the same
    vertices (PERF.md).  ``edge_rule=False`` records the early rays
    without that rule (the times must still be finite and positive).
    Returns the counts and the early rays."""
    from alifmm_tpu_torch import weld_data

    bx, by, lengths, times, reason = out
    arrived = (reason == 0) & (lengths - 2 < RAY_OPTS["max_steps"])
    ok_t = torch.isfinite(times) & (times > 0)
    early = torch.nonzero(~arrived).flatten()
    last = lengths[early] - 2
    gap = torch.hypot(bx[early, last] - rec_xy[early, 0],
                      by[early, last] - rec_xy[early, 1])
    step = RAY_OPTS["step_scale"] * weld_data.SUBGRID
    rays = [dict(ray=int(r), reason=int(reason[r]), vertices=int(lengths[r]),
                 steps_to_receiver=float(g) / step)
            for r, g in zip(early.tolist(), gap.tolist())]
    log(f"  {what}: {int(arrived.sum())} of {len(times)} rays arrived within "
        f"the step budget; finished early: {rays}; finite positive times "
        f"{int(ok_t.sum())}")
    check(bool(ok_t.all()), f"{what}: {int((~ok_t).sum())} times not "
          f"finite and positive")
    check(not edge_rule or all(r["reason"] == 1
                               and r["steps_to_receiver"] < 2.0
                               for r in rays),
          f"{what}: rays that neither arrived nor finished at the grid's "
          f"edge near their receiver: {rays}")
    return dict(arrived=int(arrived.sum()), early=rays)


def qsv_auto_arrival(model, ttfs, inputs, what, lands=True):
    """The auto tracer on the qSV fields with its defaults (the facade's
    ``ray_opts={"tracer": "auto"}``), directly, beside the descent and the
    plane search with theirs: a ray auto kept is the descent's, a retraced
    one the search's (the same march on the same inputs); it arrived if
    that tracer's ray ended for reason 0 within its step budget.  Every
    ray must arrive unless neither tracer lands it: on this weld the JAX
    package's descent runs out of steps and its search truncates (reason
    2) on rays 351, 502, 504 and 812, and auto takes the search's rays
    (PERF.md).  No auto time may be above its descent time.  With
    ``lands=False`` the rays one tracer lands and auto does not are
    recorded (``one_lands``), not held.  Returns auto's times and the
    counts."""
    from alifmm_tpu_torch import rays, weld_data

    s = weld_data.SUBGRID
    tidx, src, rec = inputs[5], inputs[3], inputs[4]
    args = (model, ttfs, tidx, src, rec, s)
    d = rays.trace_rays_descent(*args, mode="interp", return_reason=True)
    sr = rays.trace_rays(*args, mode="interp", return_reason=True)
    a = rays.trace_rays_auto(*args, mode="interp")
    Z, X = model.shape
    d_budget = rays.descent_spec(model, s, max_steps=None, step_scale=6.0,
                                 score_k=0, score_stride=1.0,
                                 mode="interp").max_steps
    s_budget = -(-5 * (Z + X) // 1)
    ok_d = (d[4] == 0) & (d[2] - 2 < d_budget)
    ok_s = (sr[4] == 0) & (sr[2] - 2 < s_budget)
    kept = a[3] == d[3]
    same = torch.where(kept, a[2] == d[2], (a[2] == sr[2]) & (a[3] == sr[3]))
    check(bool(same.all()), f"{what}: {int((~same).sum())} rays are neither "
          f"the descent's nor the search's")
    ok = torch.where(kept, ok_d, ok_s)
    fin = torch.isfinite(a[3]) & (a[3] > 0)
    lost = torch.nonzero(~ok).flatten().tolist()
    res = dict(arrived=int(ok.sum()), retraced_taken=int((~kept).sum()),
               descent_arrived=int(ok_d.sum()), search_arrived=int(ok_s.sum()),
               above_descent=int((a[3] > d[3]).sum()),
               not_arrived=[dict(ray=r, descent_reason=int(d[4][r]),
                                 descent_vertices=int(d[2][r]),
                                 search_reason=int(sr[4][r]),
                                 search_vertices=int(sr[2][r]))
                            for r in lost])
    log(f"  {what}: {res['arrived']} of {len(ok)} rays arrive "
        f"({res['retraced_taken']} of them the plane search's); the descent "
        f"alone {res['descent_arrived']} (budget {d_budget} steps), the "
        f"search alone {res['search_arrived']}; finite positive times "
        f"{int(fin.sum())}; auto times above the descent's "
        f"{res['above_descent']}; not arrived: {res['not_arrived']}")
    neither = ~ok_d & ~ok_s
    res["one_lands"] = torch.nonzero(~ok & ~neither).flatten().tolist()
    check(not lands or not res["one_lands"],
          f"{what}: rays that one tracer lands and auto does not: "
          f"{res['one_lands']}")
    check(bool(fin.all()) and res["above_descent"] == 0,
          f"{what}: {int((~fin).sum())} times not finite and positive, "
          f"{res['above_descent']} above the descent's")
    return a[3], res


QSV_RAYS_FILE = os.path.join("smoke_out", "qsv_rays_not_arrived.npz")
# (14c) the same for the qSV weld with an FD envelope
QSV_FD_RAYS_FILE = os.path.join("smoke_out",
                                "qsv_fd_envelope_rays_not_arrived.npz")
# (15c) the same for the qSH weld
QSH_RAYS_FILE = os.path.join("smoke_out", "qsh_rays_not_arrived.npz")


def save_not_arrived(ttfs, q_inputs, out, early, auto_times, lost,
                     path=QSV_RAYS_FILE, mode="qSV"):
    """Write the shear rays that did not arrive (the plane search's
    ``early`` rays with the weld's knobs, auto's ``lost`` ones) with their
    receiver fields and the table ``mode`` to ``path``, for
    tests/qsv_ray_records.py, which traces them with the JAX package."""
    tidx, src, rec = q_inputs[5], q_inputs[3], q_inputs[4]
    s_rays = np.array([r["ray"] for r in early], np.int64)
    a_rays = np.array([r["ray"] for r in lost], np.int64)
    both = np.union1d(s_rays, a_rays)
    if not len(both):
        return
    ti = tidx.cpu().numpy()[both]
    ids = np.unique(ti)

    def host(t, idx):
        return t.cpu().numpy()[idx]

    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, rays=both, tidx=ti, field_ids=ids, mode=mode,
        fields=host(ttfs, ids), src=host(src, both), rec=host(rec, both),
        search_rays=s_rays, search_len=host(out[2], s_rays),
        search_reason=host(out[4], s_rays), search_time=host(out[3], s_rays),
        auto_rays=a_rays, auto_time=host(auto_times, a_rays))
    log(f"  the rays that did not arrive and their fields: {path}")


def check_over_qp(times, qp_times, what, bounds=QSV_OVER_QP, mode="qSV"):
    """Every shear ray time within ``bounds`` of the same pair's qP time
    (QSV_OVER_QP for qSV, QSH_OVER_QP for qSH)."""
    ratio = (torch.as_tensor(times).double().cpu()
             / torch.as_tensor(qp_times).double().cpu())
    lo, hi = float(ratio.min()), float(ratio.max())
    log(f"  {what}: {mode} over qP ray time min {lo:.4f} median "
        f"{float(ratio.median()):.4f} max {hi:.4f} (bounds {bounds})")
    check(bounds[0] <= lo and hi <= bounds[1],
          f"{what}: {mode} ray times outside {bounds} of the qP times")
    return dict(min=lo, max=hi, median=float(ratio.median()))


def phase_qsv_slice(inputs, qp_times, qp_final_ms, device):
    """(11c, 11d): the qSV weld slice (31 fields, 961 rays, float32) under
    for_mode("qsv"): directly (solve_ttf + trace_rays with the weld's
    knobs; a warm-up run, then a timed one with every count set to 0 just
    before it), through ALI_FMM with the weld's knobs and with
    ``ray_opts={"tracer": "auto"}`` (likewise), K4 against its twin on
    the qSV fields; then K1 timed warm at the final shape beside the qP
    weld's time and its bound."""
    import warnings

    import alifmm_tpu_torch
    from alifmm_tpu_torch import rays, solver, weld_data
    from alifmm_tpu_torch.ops import cuda_sweep
    from alifmm_tpu_torch.ops.stencils import INF

    t0 = time.perf_counter()
    model = qsv_weld_model(torch.float32, device)
    torch.cuda.synchronize()
    log(f"  qSV weld model build {time.perf_counter() - t0:.3f} s")
    q_inputs = (model,) + tuple(inputs[1:])
    cfg = solver.SolveConfig.for_mode("qsv")
    t0 = time.perf_counter()
    run_slice(q_inputs, cfg=cfg)
    log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    reset_counts()
    ttfs, info, out, (t_solve, t_rays, wall) = run_slice(q_inputs, rec, cfg)
    counts = read_counts()
    times = out[3]
    log(f"  direct qSV weld slice warm wall clock {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s)")
    for name, sec in stages:
        log(f"    stage [{name}] {sec:.4f} s")
    log(f"  final stage passes {info.passes} converged {info.converged}")
    log(f"  launches and plain-twin counts: {counts}")
    check_tracer_counts(counts, "search", 0, "the direct qSV weld slice")
    check(info.converged and info.passes < 96,
          f"qSV weld: the final stage did not converge in 96 passes "
          f"({info.passes}, converged {info.converged})")
    check(ttfs.shape == (31, 424, 500), f"field shape {tuple(ttfs.shape)}")
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          "qSV weld fields not finite everywhere")
    res = dict(wall=wall, solve=t_solve, rays=t_rays, stages=stages,
               passes=info.passes, converged=info.converged, counts=counts,
               ttfs=ttfs,
               search=qsv_search_ends(out, q_inputs[4], "qSV weld, search"),
               over_qp=check_over_qp(times, qp_times, "qSV weld, direct"))

    auto_times, res["auto"] = qsv_auto_arrival(model, ttfs, q_inputs,
                                               "qSV weld, auto (direct)")
    save_not_arrived(ttfs, q_inputs, out, res["search"]["early"],
                     auto_times, res["auto"]["not_arrived"])
    alifmm_tpu_torch.tqdm_disable = True  # a bar synchronises every stage
    veln, velpn, vel_map = qsv_weld_arrays()
    _, _, _, _, sx, sy, pairs, dnx = weld_data.workload(0)
    g, p = qsv_tables()
    pi, pj = np.nonzero(pairs == 1)
    direct = {"search": times.double().cpu().numpy(),
              "auto": auto_times.double().cpu().numpy()}
    for tracer, ray_opts in (("search", RAY_OPTS),
                             ("auto", {"tracer": "auto"})):
        fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy,
                                      group_vel=g, phase_vel=p, dnx=dnx,
                                      ray_opts=ray_opts, solve_opts=cfg)

        def call():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                tmat = fm.find_all_TTF_rays_parallel(
                    veln, velpn, vel_map, trans_pairs=pairs, n_threads=8)
                torch.cuda.synchronize()
                return tmat, time.perf_counter() - t0

        call()
        reset_counts()
        tmat, f_wall = call()
        f_counts = read_counts()
        what = f"qSV weld facade, tracer {tracer}"
        check_tracer_counts(f_counts, tracer, f_counts["march"], what)
        traced = pairs == 1
        got = tmat[pi, pj]
        ok = np.isfinite(got) & (got > 0)
        log(f"  {what}: warm call {f_wall:.4f} s; {int(ok.sum())} of "
            f"{len(got)} finite positive times; counts {f_counts}")
        check(bool(ok.all()) and len(got) == 961 and not tmat[~traced].any()
              and np.array_equal(fm.ray_len > 0, traced),
              f"{what}: times not finite and positive on exactly the 961 "
              f"pairs")
        entry = dict(wall=f_wall, counts=f_counts,
                     over_qp=check_over_qp(got, qp_times, what))
        rel = float((np.abs(got - direct[tracer]) / direct[tracer]).max())
        log(f"  {what}: times against the direct path's max rel {rel:.3e}")
        check(rel <= 1e-6, f"{what}: times differ from the direct path's")
        entry["vs_direct_max_rel"] = rel
        if tracer == "auto":
            gap = (got - direct["search"]) / direct["search"]
            entry["vs_search"] = dict(max_abs_rel=float(np.abs(gap).max()),
                                      median_rel=float(np.median(gap)))
            log(f"  {what}: times against the weld knobs' search: max |rel| "
                f"{entry['vs_search']['max_abs_rel']:.4e}, median "
                f"{entry['vs_search']['median_rel']:.4e}")
        res[f"facade_{tracer}"] = entry

    # K4 against its twin on the qSV fields, the facade's descent defaults
    mat_flat, tidx, src, rec_xy, spec, cross = descent_inputs(
        model, {}, weld_data.SUBGRID, sx, sy, pairs, dnx)
    args = (model, mat_flat, ttfs, tidx, src, rec_xy, spec)
    ms_twin, want = time_host(lambda: rays.descent_plain(*args))
    k4 = descent_vs_twin(args, want, cross, torch.float32,
                         "qSV weld score_k 0 float32")
    reasons = {int(k): int(v) for k, v in
               zip(*np.unique(want[3].cpu().numpy(), return_counts=True))}
    arrived = int(((want[3] == 0) & (want[4] < spec.max_steps)).sum())
    log(f"  K4 on the qSV fields (twin {ms_twin:.1f} ms): rays by reason "
        f"(0 arrived or out of steps, 1 stalled) {reasons}; arrived within "
        f"the {spec.max_steps}-step budget {arrived} of 961")
    k4.update(reasons=reasons, arrived=arrived, plain_ms=ms_twin)
    res["k4"] = k4

    # (11d) K1 warm at the final shape, beside the qP weld's (phase 8)
    name, fmodel, tt0, fixed = stage_inputs(q_inputs, cfg)[-1]
    packed = cuda_sweep.pack_model(fmodel)
    B, Z, X = tt0.shape
    C, G = cuda_sweep.launch_config(B, Z, X, cuda_sweep._sm_count(
        tt0.device))
    ms, _ = time_k1(tt0, fixed, packed)
    bound, by = bound_ms(tt0, fixed, packed)
    log(f"  [11d] qSV {name} ({B} sources) K1 {ms:.4f} ms per pass at C={C} "
        f"G={G}; bound {bound:.4f} ms ({by}), share {bound / ms:.4f}; the "
        f"qP weld's final shape {qp_final_ms:.4f} ms (phase 8)")
    res["k1"] = dict(stage=name, sources=B, cluster=C, lanes=G, ms=ms,
                     bound_ms=bound, bound_by=by, share=bound / ms,
                     qp_ms=qp_final_ms)
    return res



# --------------------------------------------------------------------- #
# Phase 12: the sharded solves (parallel/shard, parallel/multihost) and
# the slab sweep kernel K5
# --------------------------------------------------------------------- #

def virtual_mesh(device, kind):
    """Meshes of virtual ranks on one card: "1d" four z slabs ("gz"),
    "2d" 2 x 2 z and x blocks ("gz", "gx"), "3" three z slabs, "src"
    four source ranks.  Returns (mesh, axis)."""
    from alifmm_tpu_torch.parallel import Mesh

    if kind == "2d":
        arr = np.empty((2, 2), dtype=object)
        arr.fill(device)
        return Mesh(arr, ("gz", "gx")), ("gz", "gx")
    n, name = {"1d": (4, "gz"), "3": (3, "gz"), "src": (4, "src")}[kind]
    return Mesh([device] * n, (name,)), name


def padded_case(Z, X, rows, cols, dtype, device, B=3, make=random_model):
    """A seeded (Z, X) model of ``make`` and fields padded by ``rows`` and
    ``cols`` with fixed INF points and edge materials, as solve_ttf_halo
    pads them: (tt, model, fixed)."""
    import torch.nn.functional as F

    from alifmm_tpu_torch.ops.stencils import INF
    from alifmm_tpu_torch.parallel import shard

    model = make(Z, X, dtype, device, seed=Z * 1000 + X)
    tt, fixed = seeded((Z, X), B, dtype, device)
    return (F.pad(tt, (0, cols, 0, rows), value=INF),
            shard._edge_pad(model, rows, cols),
            F.pad(fixed, (0, cols, 0, rows), value=True))


# K5 layouts a case runs, each against the same twin: slab_config's own
# ({}), or forced through SlabSweep's per_line, cluster and lanes.  At
# 48 x 56 slab_config takes c = 2, G = 8 for the four slabs' x-sweeps (16
# wide, a cluster of 8 CTAs) and c = 4 for their z-sweeps; c = 4 and c =
# 2 for the 2 x 2 blocks' z- and x-sweeps (32 and 28 wide); c = 3 gives
# ragged tiles (11, 11, 10 and 10, 10, 8) in clusters of 6 CTAs.
AUTO_LAYOUT = ({},)
FORCED_1D = AUTO_LAYOUT + ({"cluster": 1, "lanes": 4}, {"per_line": True})
FORCED_2D = AUTO_LAYOUT + ({"cluster": 3}, {"per_line": True})
# (mesh, Z, X, padded rows, padded columns, K5 layouts, model builder) of
# phase 12a's cases: random_model's qP models (a stiffness block and a
# constant table column), and qSV ones that give K5 an interpolated table
# column (column mode 2), as QSV_PASS_CASES give K1.
HALO_CASES = {
    "1D 4 slabs 48x56": ("1d", 48, 56, 0, 0, FORCED_1D, random_model),
    "2D 2x2 48x56": ("2d", 48, 56, 0, 0, FORCED_2D, random_model),
    "1D 4 slabs 46x56 padded to 48": ("1d", 46, 56, 2, 0, AUTO_LAYOUT,
                                      random_model),
    "2D 2x2 46x54 padded to 48x56": ("2d", 46, 54, 2, 2, AUTO_LAYOUT,
                                     random_model),
    "1D 4 slabs qSV 48x56": ("1d", 48, 56, 0, 0, AUTO_LAYOUT,
                             qsv_random_model),
    "2D 2x2 qSV 48x56": ("2d", 48, 56, 0, 0, AUTO_LAYOUT, qsv_random_model),
}


def halo_lines(h):
    """(keys, axis, refresh) of every sweep of a halo pass on ``h``'s
    blocks: each a line of blocks across the width."""
    if h.two_d:
        return ([(tuple((s, ix) for ix in range(h.nx)), "z", True)
                 for s in range(h.nz)]
                + [(tuple((iz, s) for iz in range(h.nz)), "x", True)
                   for s in range(h.nx)])
    return ([(((s, 0),), "z", False) for s in range(h.nz)]
            + [(tuple((iz, 0) for iz in range(h.nz)), "x", True)])


def chain(n):
    """The halo neighbours (before, after) of a line of n blocks."""
    return [(j - 1 if j else None, j + 1 if j < n - 1 else None)
            for j in range(n)]


def bind_layout(h, layout):
    """Bind K5 to every line of blocks of ``h`` with ``layout`` (keywords
    of SlabSweep: per_line, cluster, lanes) forced, as ``_Halo.sweep``
    would bind it."""
    from alifmm_tpu_torch.ops import cuda_sweep

    for keys, axis, refresh in halo_lines(h):
        h.kernels[keys, axis] = cuda_sweep.SlabSweep(
            [h.t[k] for k in keys], [h.f[k] for k in keys],
            [h.packs[k] for k in keys], axis,
            [h.geometry(k, axis) for k in keys],
            chain(len(keys)) if refresh else None, **layout)


def halo_pair(tt, model, fixed, mesh, axis, z_true=None, x_true=None,
              layouts=AUTO_LAYOUT):
    """Halo states of the same inputs: the plain twin's (graphed) and one
    of K5's for each of ``layouts``, after their first halo exchange."""
    from alifmm_tpu_torch.parallel import shard

    grid, two_d = shard._halo_grid(mesh, axis)
    states = [shard._Halo(tt, model, fixed, grid, two_d, z_true, x_true,
                          plain=plain)
              for plain in [True] + [False] * len(layouts)]
    for h, layout in zip(states[1:], layouts):
        if layout:
            bind_layout(h, layout)
    for h in states:
        if two_d:
            h.exchange_x()
        h.exchange_z()
    return states


def halo_diff(hp, hk, what):
    """K5's blocks against the twin's, every point, halos included: the
    largest absolute difference, which must be 0."""
    torch.cuda.synchronize()
    worst = 0.0
    for k in hp.keys:
        a, b = hk.t[k].double(), hp.t[k].double()
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
              f"{what}: K5 and its twin disagree on which points are finite")
        worst = max(worst, float((a - b).abs().max()))
    check(worst == 0.0, f"{what}: K5 differs from its twin (max abs "
          f"{worst:.3e})")
    return worst


def check_halo_case(name, dtype, device):
    """(12a) K5 against its graphed twin, max abs 0, in each of the case's
    layouts: every directional sweep of a halo pass as a bare launch (each
    z slab, each line of blocks), min and replace, then one pass through
    _halo_jacobi_block or _halo_block2d; and one sweep through the wrapper
    cuda_sweep.slab_sweep."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep
    from alifmm_tpu_torch.parallel import shard

    kind, Z, X, rows, cols, layouts, make = HALO_CASES[name]
    mesh, axis = virtual_mesh(device, kind)
    tt, model, fixed = padded_case(Z, X, rows, cols, dtype, device,
                                   make=make)
    hp, *hks = halo_pair(tt, model, fixed, mesh, axis,
                         Z if rows else None, X if cols else None, layouts)
    hk = hks[0]
    dname = str(dtype).replace("torch.", "")
    two_d = hp.two_d
    t0 = time.perf_counter()
    n = 0

    def diff(what):
        for h, layout in zip(hks, layouts):
            halo_diff(hp, h, f"{name} {dname} {layout or 'slab_config'} "
                      f"{what}")
    for replace in (False, True):
        mode = "replace" if replace else "min"
        for axis_, count in (("z", hp.nz), ("x", hp.nx if two_d else 1)):
            for rev in (False, True):
                for s in (range(count - 1, -1, -1) if rev else range(count)):
                    if axis_ == "z":
                        keys = ([(s, ix) for ix in range(hp.nx)] if two_d
                                else [(s, 0)])
                    else:
                        keys = ([(iz, s) for iz in range(hp.nz)] if two_d
                                else [(iz, 0) for iz in range(hp.nz)])
                    refresh = two_d or axis_ == "x"
                    hp.sweep(keys, axis_, rev, replace, refresh)
                    lines = hp.t[keys[0]].shape[-1 if axis_ == "x" else -2]
                    for h, layout in zip(hks, layouts):
                        # a launch a sweep, but a line (and one more) in
                        # the per-line schedule
                        want = (lines + 1 if refresh and layout.get("per_line")
                                else 1)
                        n0 = cuda_sweep.SLAB_LAUNCHES
                        h.sweep(keys, axis_, rev, replace, refresh)
                        got = cuda_sweep.SLAB_LAUNCHES - n0
                        check(got == want, f"{name} {layout or 'slab_config'}"
                              f": {got} K5 launches for a sweep, not {want}")
                    diff(f"{axis_} rev={rev} {mode} blocks {keys}")
                    n += 1
        block = shard._halo_block2d if two_d else shard._halo_jacobi_block
        for h in (hp, *hks):
            block(h, 1, replace)
        diff(f"{block.__name__} {mode}")
    k = (1, 0)
    geom = [hp.geometry(k, "z")]
    new_p = sweep.slab_sweep([hp.t[k]], [hp.m[k]], [hp.f[k]], "z", False,
                             False, geom, graphed=True)
    new_k = cuda_sweep.slab_sweep([hk.t[k]], [hk.m[k]], [hk.f[k]], "z", False,
                                  False, geom)
    torch.cuda.synchronize()
    check(torch.equal(new_k[0], new_p[0]),
          f"{name} {dname}: cuda_sweep.slab_sweep differs from its twin")
    log(f"  {name} {dname}: {n} bare sweeps and 2 halo passes in "
        f"{len(layouts)} layout(s), and one wrapper sweep, equal to the "
        f"twin, max abs 0 ({time.perf_counter() - t0:.1f} s)")
    return 0.0


def phase_halo_kernel(device):
    """(12a) K5 against its twin on every HALO_CASES case, both types."""
    for dtype in (torch.float64, torch.float32):
        for name in HALO_CASES:
            check_halo_case(name, dtype, device)
    return 0.0


def phase_halo_fixed(inputs, device):
    """(12b) solve_halo_sharded with a fixed budget against K1's
    single-device solve_fixpoint with the matched budget (rel_tol 0: every
    phase-1 pass runs), max abs 0: 48 x 56 (three sources) on the 4-slab,
    2 x 2 and 3-slab meshes (the last 50 x 56, padded to 51 rows) and qSV
    48 x 56 (``qsv_random_model``: K5's interpolated table column) on the
    4-slab and 2 x 2 meshes, in float64 and float32; the weld's final stage
    (its injected state, 31 x 424 x 500, float32, 3 + 2 passes) on the
    4-slab and 2 x 2 meshes."""
    from alifmm_tpu_torch.ops import cuda_sweep
    from alifmm_tpu_torch.parallel import shard

    out = {}

    def one(what, tt, model, fixed, kind, n_outer, polish, rows=0):
        mesh, axis = virtual_mesh(device, kind)
        t0 = time.perf_counter()
        want, info = cuda_sweep.solve_fixpoint(
            tt, model, fixed, rel_tol=0.0, max_passes=n_outer,
            polish_passes=polish)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if rows:
            import torch.nn.functional as F

            from alifmm_tpu_torch.ops.stencils import INF

            Z = tt.shape[-2]
            got = shard.solve_halo_sharded(
                F.pad(tt, (0, 0, 0, rows), value=INF),
                shard._edge_pad(model, rows, 0),
                F.pad(fixed, (0, 0, 0, rows), value=True), mesh, axis=axis,
                n_outer=n_outer, n_inner=1, polish=polish, z_true=Z)[..., :Z, :]
        else:
            got = shard.solve_halo_sharded(tt, model, fixed, mesh, axis=axis,
                                           n_outer=n_outer, n_inner=1,
                                           polish=polish)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
        e = float((got.double() - want.double()).abs().max())
        log(f"  {what} on {kind}: max abs {e:.3e} against K1 ({info.passes} "
            f"phase-1 passes; K1 {t1 - t0:.3f} s, halo {t2 - t1:.3f} s)")
        check(e == 0.0, f"{what} on {kind}: the halo solve differs from K1's")
        out[f"{what} {kind}"] = dict(k1_s=t1 - t0, halo_s=t2 - t1)

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        model = small_model(dtype, device)
        tt, fixed = seeded(model.shape, 3, dtype, device)
        for kind in ("1d", "2d"):
            one(f"48x56 {dname}", tt, model, fixed, kind, 6, 2)
        model = random_model(50, 56, dtype, device, seed=50056)
        tt, fixed = seeded(model.shape, 3, dtype, device)
        one(f"50x56 padded to 51 {dname}", tt, model, fixed, "3", 6, 2,
            rows=1)
        model = qsv_random_model(48, 56, dtype, device, seed=48056)
        tt, fixed = seeded(model.shape, 3, dtype, device)
        for kind in ("1d", "2d"):
            one(f"qSV 48x56 {dname}", tt, model, fixed, kind, 6, 2)
    name, model, tt0, fixed = stage_inputs(inputs)[-1]
    for kind in ("1d", "2d"):
        one(f"weld final stage {name}", tt0, model, fixed, kind, 3, 2)
    return out


def slab_work(h, k):
    """The work of one sweep of block ``k``: the operations of its points
    that are not fixed (``update_ops`` by path), and the bytes of its
    field read and written once, its fixed mask and 12 material planes
    read once."""
    packed = h.packs[k]
    fixed = h.f[k]
    ops = int((update_ops(packed) * ~fixed).sum())
    item = h.t[k].element_size()
    nbytes = (2 * h.t[k].numel() * item + fixed.numel()
              + packed.planes.numel() * item)
    return ops, nbytes


def slab_bound(h, keys, sweeps=1):
    """K5's bound for ``sweeps`` sweeps of each block of ``keys``: the
    roofline of their work summed."""
    work = [slab_work(h, k) for k in keys]
    return roofline(sweeps * sum(o for o, _ in work),
                    sweeps * sum(b for _, b in work))



# K5 launches a halo round at the weld (n_inner = 1): four slabs, 8 slab
# z-sweeps and 2 refreshed x-sweeps; 2 x 2, 8 refreshed sweeps of a line
# of two blocks.  solve_ttf_halo there takes 3 + 2 rounds.
ROUND_LAUNCHES = {"1d": 10, "2d": 8}
WELD_HALO_ROUNDS = 5


def phase_halo_weld(inputs, ttfs, k1_ms, device):
    """(12c) solve_ttf_halo on the weld (weld budgets, residual-driven) on
    the 4-slab and the 2 x 2 mesh: passes, converged, the largest
    difference from the single-device staged solve, finite fields, K5
    launches (checked); then on the weld's final-stage input: one K5
    z-sweep of a slab against its graphed twin (max abs 0) and timed
    beside its bound and the twin, the refreshed x-sweep of the four slabs
    in one launch against its graphed twin (max abs 0) and timed beside
    its bound and beside the per-line schedule and its one-line launch,
    one halo round of each layout beside K1's pass and its bound (K5
    launches checked), and the exchange copies and bytes a round."""
    from alifmm_tpu_torch import solver
    from alifmm_tpu_torch.ops import cuda_sweep
    from alifmm_tpu_torch.parallel import shard

    model, scx, scz = inputs[:3]
    cfg = solver.SolveConfig(**SOLVE_KW)
    tol = SOLVE_KW["final_rel_tol"]
    out = {}
    scale = float(ttfs.max())
    for kind in ("1d", "2d"):
        mesh, axis = virtual_mesh(device, kind)
        shard.solve_ttf_halo(model, scx, scz, mesh, axis=axis, cfg=cfg)
        cuda_sweep.SLAB_LAUNCHES = 0
        t0 = time.perf_counter()
        got, info = shard.solve_ttf_halo(model, scx, scz, mesh, axis=axis,
                                         cfg=cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_sweep.SLAB_LAUNCHES
        check(got.shape == ttfs.shape, f"halo weld shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "halo weld fields not finite")
        diff = float((got - ttfs).abs().max())
        abs_e, rel_e = rel_err(got, ttfs)
        log(f"  solve_ttf_halo on {kind}: {wall:.4f} s warm, final passes "
            f"{info.passes} converged {info.converged}, K5 launches "
            f"{launches}; against the single-device solve max abs "
            f"{abs_e:.3e} (the residual stop allows {tol} x {scale:.3e}), "
            f"max rel {rel_e:.3e}")
        check(diff <= tol * scale, f"halo weld on {kind} differs from the "
              f"single-device solve by {diff:.3e}")
        want = WELD_HALO_ROUNDS * ROUND_LAUNCHES[kind]
        check(launches == want, f"solve_ttf_halo on {kind} launched K5 "
              f"{launches} times, not {want}")
        out[kind] = dict(wall=wall, passes=info.passes,
                         converged=info.converged, launches=launches,
                         max_abs=abs_e, max_rel=rel_e)
    # K5 at the weld's final shape
    name, model, tt0, fixed = stage_inputs(inputs)[-1]
    mesh, axis = virtual_mesh(device, "1d")
    hp, hk = halo_pair(tt0, model, fixed, mesh, axis)
    k = (1, 0)
    ms_twin, _ = time_host(lambda: hp.sweep([k], "z", False, False, False))
    hk.sweep([k], "z", False, False, False)
    check(torch.equal(hk.t[k], hp.t[k]),
          "K5's slab z-sweep at the weld differs from its twin")
    ms = time_events(lambda: hk.sweep([k], "z", False, False, False), 5)
    bound, by = slab_bound(hk, [k])
    lines = hk.t[k].shape[-2]
    B = tt0.shape[0]
    k1_line_us = k1_ms / (2 * sum(tt0.shape[1:])) * 1e3
    log(f"  K5 one z-sweep of slab 1 ({tuple(hk.t[k].shape)}, {lines} "
        f"lines) {ms:.4f} ms ({ms / lines * 1e3:.2f} us a line; K1 "
        f"{k1_line_us:.2f} us a line step of its pass), bound {bound:.4f} "
        f"ms ({by}), share {bound / ms:.4f}; graphed twin {ms_twin:.1f} "
        f"ms, equal bit for bit")
    # the refreshed x-sweep of the four slabs: one launch, then the
    # per-line schedule on the same slabs
    slabs = tuple((iz, 0) for iz in range(hk.nz))
    for s in slabs:  # the timed z-sweeps moved slab 1 on
        hk.t[s].copy_(hp.t[s])
    ms_twin_x, _ = time_host(lambda: hp.sweep(slabs, "x", False, False,
                                              True))
    l0 = cuda_sweep.SLAB_LAUNCHES
    hk.sweep(slabs, "x", False, False, True)
    n_x = cuda_sweep.SLAB_LAUNCHES - l0
    worst_x = halo_diff(hp, hk, "K5's refreshed x-sweep at the weld")
    check(n_x == 1, f"the refreshed x-sweep took {n_x} K5 launches, not 1")
    lay = hk.kernels[slabs, "x"].layout
    ms_x = time_events(lambda: hk.sweep(slabs, "x", False, False, True), 5)
    bound_x, by_x = slab_bound(hk, slabs)
    lines_x = hk.t[k].shape[-1]
    per = cuda_sweep.SlabSweep(
        [hk.t[s] for s in slabs], [hk.f[s] for s in slabs],
        [hk.packs[s] for s in slabs], "x",
        [hk.geometry(s, "x") for s in slabs], chain(len(slabs)),
        per_line=True)
    ms_per = time_events(lambda: per.run(False, False), 3)
    line_ms = time_events(lambda: per.launch(250, 1, 1, 249, False), 50)
    log(f"  K5 the refreshed x-sweep, 4 slabs x {B} sources ({lines_x} "
        f"lines, {lay}): one launch {ms_x:.4f} ms ({ms_x / lines_x * 1e3:.2f}"
        f" us a line), bound {bound_x:.4f} ms ({by_x}), share "
        f"{bound_x / ms_x:.4f}; graphed twin {ms_twin_x:.1f} ms, max abs "
        f"{worst_x}; the per-line schedule {ms_per:.4f} ms "
        f"({ms_per / ms_x:.1f} x), a one-line launch {line_ms * 1e3:.2f} us")
    rounds = {}
    for kind in ("1d", "2d"):
        mesh, axis = virtual_mesh(device, kind)
        grid, two_d = shard._halo_grid(mesh, axis)
        h = shard._Halo(tt0, model, fixed, grid, two_d, None, None)
        block = shard._halo_block2d if two_d else shard._halo_jacobi_block
        block(h, 1, False)
        c0, b0, l0 = h.copies, h.copy_bytes, cuda_sweep.SLAB_LAUNCHES
        block(h, 1, False)
        copies, nbytes = h.copies - c0, h.copy_bytes - b0
        n_launch = cuda_sweep.SLAB_LAUNCHES - l0
        r_ms = time_events(lambda: block(h, 1, False), 3)
        r_bound, r_by = slab_bound(h, h.keys, sweeps=4)
        log(f"  halo round on {kind}: {r_ms:.3f} ms ({r_ms / k1_ms:.2f} x "
            f"K1's {k1_ms:.3f} ms pass), bound {r_bound:.4f} ms ({r_by}), "
            f"share {r_bound / r_ms:.4f}, {n_launch} K5 launches, {copies} "
            f"exchange copies, {nbytes} bytes")
        check(n_launch == ROUND_LAUNCHES[kind], f"a halo round on {kind} "
              f"launched K5 {n_launch} times, not {ROUND_LAUNCHES[kind]}")
        rounds[kind] = dict(ms=r_ms, bound_ms=r_bound, bound_by=r_by,
                            share=r_bound / r_ms, k5_launches=n_launch,
                            copies=copies, copy_bytes=nbytes)
    return dict(solves=out, slab_sweep=dict(
        ms=ms, plain_ms=ms_twin, bound_ms=bound, bound_by=by, lines=lines,
        us_per_line=ms / lines * 1e3, share=bound / ms,
        shape=list(hk.t[k].shape), k1_us_per_line=k1_line_us),
        refreshed_x_sweep=dict(
            ms=ms_x, plain_ms=ms_twin_x, bound_ms=bound_x, bound_by=by_x,
            share=bound_x / ms_x, lines=lines_x,
            us_per_line=ms_x / lines_x * 1e3, launches=n_x,
            max_abs_err=worst_x, layout=lay._asdict(),
            per_line_ms=ms_per),
        us_per_line_launch=line_ms * 1e3, rounds=rounds, k1_pass_ms=k1_ms)


def free_port():
    """A free TCP port on localhost (for the one-rank process group)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_sharded_weld(inputs, device):
    """(12d) solve_ttf_sharded (4 virtual source ranks) and
    trace_rays_sharded (961 rays) against the unsharded weld slice, bit
    for bit; then the same through multihost.init on a one-rank NCCL
    group (tcp://localhost), whose collectives (the final stage's
    all-reduce a pass, the all-gathers) then run, left at the end."""
    from alifmm_tpu_torch import rays, solver, weld_data
    from alifmm_tpu_torch.parallel import multihost, shard

    model, scx, scz, src_xy, rec_xy, tidx = inputs
    cfg = solver.SolveConfig(**SOLVE_KW)
    mesh, axis = virtual_mesh(device, "src")
    want_f = solver.solve_ttf(model, scx, scz, 1, cfg)
    want_r = rays.trace_rays(model, want_f, tidx, src_xy, rec_xy,
                             weld_data.SUBGRID, mode="interp", **RAY_OPTS)
    sx, sz = scx.cpu().numpy(), scz.cpu().numpy()
    out = {}

    def run(what):
        t0 = time.perf_counter()
        got_f = shard.solve_ttf_sharded(model, sx, sz, mesh, axis=axis,
                                        cfg=cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got_r = shard.trace_rays_sharded(model, want_f, tidx, src_xy, rec_xy,
                                         weld_data.SUBGRID, mesh, axis=axis,
                                         **RAY_OPTS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(torch.equal(got_f, want_f),
              f"{what}: solve_ttf_sharded differs from the unsharded solve")
        for a, b in zip(got_r, want_r):
            check(torch.equal(a, b), f"{what}: trace_rays_sharded differs "
                  f"from the unsharded trace")
        log(f"  {what}: fields and rays equal to the unsharded slice bit for "
            f"bit (solve {t1 - t0:.4f} s, rays {t2 - t1:.4f} s)")
        out[what] = dict(solve=t1 - t0, rays=t2 - t1)

    run("4 source ranks")
    port = free_port()
    check(multihost.init(f"tcp://localhost:{port}", 1, 0),
          "multihost.init did not set up the group")
    try:
        log(f"  {multihost.process_summary()}")
        run("4 source ranks in a one-rank NCCL group")
    finally:
        multihost.shutdown()
    return out


def phase_halo_facade(device):
    """(12e) ALI_FMM(grid_mesh=4 virtual z slabs) on the weld slice against
    the plain facade: a warm-up call each, then a timed call with every
    count set to 0 just before it (this slice's main path: K1 for the
    patches, K5 for the final stage, one K2 and one K3, no plain pass);
    the ray times and the fields (``update``) within the residual stop of
    the plain facade's."""
    import alifmm_tpu_torch
    from alifmm_tpu_torch import weld_data

    alifmm_tpu_torch.tqdm_disable = True
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    mesh, axis = virtual_mesh(device, "1d")
    fms = {}
    for key, kw in (("mesh", dict(grid_mesh=mesh, grid_axis=axis)),
                    ("plain", {})):
        fms[key] = alifmm_tpu_torch.ALI_FMM(
            veln, velpn, vel_map, sx, sy, stif_den=stif, dnx=dnx,
            ray_opts=RAY_OPTS, solve_opts=SOLVE_KW, **kw)

    def call(fm):
        t0 = time.perf_counter()
        out = fm.find_all_TTF_rays_parallel(veln, velpn, vel_map,
                                            stif_den=stif, trans_pairs=pairs,
                                            n_threads=8)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    walls = {}
    for key in ("plain", "mesh"):
        call(fms[key])
        if key == "mesh":
            reset_counts()
        tmat, walls[key] = call(fms[key])
        if key == "mesh":
            counts = read_counts()
            t_mesh = tmat
        else:
            t_plain = tmat
    log(f"  facade with grid_mesh: {walls['mesh']:.4f} s warm (plain facade "
        f"{walls['plain']:.4f} s); launches and plain-twin counts: {counts}")
    want = WELD_HALO_ROUNDS * ROUND_LAUNCHES["1d"]
    check(counts["slab_sweep"] == want, f"the facade with grid_mesh launched "
          f"K5 {counts['slab_sweep']} times, not {want}")
    check_counts(counts, "the facade with grid_mesh")
    traced = t_plain > 0
    check(np.array_equal(t_mesh > 0, traced) and bool(np.isfinite(t_mesh).all()),
          "the facade with grid_mesh traced other pairs")
    rel_t = float(np.max(np.abs(t_mesh[traced] - t_plain[traced])
                         / t_plain[traced]))
    f_mesh = fms["mesh"].update(veln, velpn, vel_map, stif_den=stif)
    f_plain = fms["plain"].update(veln, velpn, vel_map, stif_den=stif)
    tol = SOLVE_KW["final_rel_tol"]
    d_f = float(np.max(np.abs(f_mesh - f_plain)))
    scale = float(f_plain.max())
    log(f"  facade with grid_mesh against the plain facade: ray times max "
        f"rel {rel_t:.3e}, fields max abs {d_f:.3e} (the residual stop "
        f"allows {tol} x {scale:.3e})")
    check(d_f <= tol * scale and rel_t <= tol,
          "the facade with grid_mesh differs from the plain facade beyond "
          "the residual stop")
    return dict(wall=walls["mesh"], plain_wall=walls["plain"],
                counts=counts, times_max_rel=rel_t, fields_max_abs=d_f)


# --------------------------------------------------------------------- #
# Phase 13: the tutorial's workload (examples/tutorial_torch.ipynb)
# --------------------------------------------------------------------- #

# The notebook's sizes: n x n cells of dnx, three transducers on the top
# edge, v = V0 + DV m/s a row (g = DV / dnx), float32 (the facade's
# default), rays at subgrid_size 9.
TUTORIAL_N = 201
TUTORIAL_DNX = 1e-3
TUTORIAL_COLS = (40.0, 100.0, 160.0)
TUTORIAL_V0, TUTORIAL_DV = 3000.0, 10.0
TUTORIAL_NEAR = 5            # cells around a source left out of 13a
TUTORIAL_STIFF = (263e9, 148e9, 216e9, 129e9, 8100)
# (13a) the gradient field against the analytic time, (largest, mean)
# relative error over any source: the JAX package's own error on this
# model at n = 201 on the CPU in float64 (tests/tutorial_records.py:
# 1.78620e-2 / 4.86712e-3, the largest of the three sources), rounded up,
# plus a float32 margin.  The same record in float32 moved the two by
# 6.8e-8 and 5.4e-8 (1.78621e-2 / 4.86717e-3); the margin is about 15
# times that, room for the card's float32 to round other operations
# than JAX's does.
TUTORIAL_JAX_ERROR = (1.78620e-2, 4.86712e-3)
TUTORIAL_F32_MARGIN = (1e-6, 1e-6)
TUTORIAL_RAY_TOL = 1e-2      # (13c) against the analytic surface time
TUTORIAL_STRAIGHT_TOL = 1e-4  # (13c) above the straight path's time
TUTORIAL_MODELS_TOL = 1e-3   # (13d) table against Christoffel fields


def tutorial_arrays():
    """The notebook's gradient model: (veln, velpn, vel_map, scx, scz)."""
    n = TUTORIAL_N
    veln = np.zeros((n, n))
    velpn = np.ones((n, n), dtype=int)
    vel_map = TUTORIAL_V0 + TUTORIAL_DV * np.arange(n)[:, None] * np.ones(
        (1, n))
    scx = TUTORIAL_DNX * np.array(TUTORIAL_COLS)
    return veln, velpn, vel_map, scx, np.zeros(3)


def gradient_time(scx, n=TUTORIAL_N):
    """The analytic first arrival from (x, 0) in v = V0 + g z at every
    point, (3, n, n): arccosh(1 + g^2 r^2 / (2 V0 v)) / g, with r^2 the
    squared distances (also returned)."""
    g = TUTORIAL_DV / TUTORIAL_DNX
    iz, ix = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z, x = iz * TUTORIAL_DNX, ix * TUTORIAL_DNX
    r2 = np.stack([(x - sx) ** 2 + z ** 2 for sx in scx])
    v = TUTORIAL_V0 + g * z
    return np.arccosh(1.0 + g * g * r2 / (2.0 * TUTORIAL_V0 * v)) / g, r2


def surface_time(dx):
    """The analytic first arrival between two points of the top edge dx
    apart: (2 / g) asinh(g dx / (2 V0))."""
    g = TUTORIAL_DV / TUTORIAL_DNX
    return 2.0 / g * np.arcsinh(g * dx / (2.0 * TUTORIAL_V0))


def tutorial_call(what, fn, rays=False):
    """A warm-up call, then a timed one with every count set to 0 just
    before it: K1 launched, no plain pass or step, and with ``rays`` one K2
    and one K3.  Returns (result, record)."""
    fn()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  {what}: {wall:.4f} s warm; launches {counts}")
    if rays:
        check_counts(counts, what)
    else:
        check(counts["sweep_pass"] > 0, f"{what} launched no sweep_pass")
        check(counts["plain_passes"] == 0 and counts["march"] == 0
              and counts["relax_times"] == 0,
              f"{what} ran a plain pass or a ray kernel: {counts}")
    return out, dict(wall=wall, counts=counts)


def tutorial_k1(model, scx, scz, sel, every_stage, what):
    """(13e) K1 against the graphed twin on the stage inputs of the
    facade's solve of ``model`` (its budget, float32) for the sources
    ``sel``, at both of AUTO's launch shapes, held to max abs 0: a min
    pass at the final stage, and with ``every_stage`` a min pass at every
    stage and a replace pass on the twin's result at the final one.
    Returns the final stage's (model, field, fixed, the twin's min pass)
    and the largest difference."""
    from alifmm_tpu_torch import solver

    def as_dev(a):
        return torch.as_tensor(np.asarray(a)[sel], dtype=model.dtype,
                               device=model.device)

    stages = stage_inputs((model, as_dev(scx), as_dev(scz)),
                          solver.SolveConfig())
    worst = 0.0
    for name, m, tt0, fixed in stages if every_stage else stages[-1:]:
        label = f"(13e) {what}, {len(sel)} sources, {name}"
        mid, e = check_pass(m, tt0, fixed, False, torch.float32,
                            f"{label} min", graphed=True)
        worst = max(worst, e)
    if every_stage:
        _, e = check_pass(m, mid, fixed, True, torch.float32,
                          f"{label} replace", graphed=True)
        worst = max(worst, e)
    check(worst == 0.0, f"(13e) {what}: K1 differs from its twin by "
          f"{worst:.3e}")
    return (m, tt0, fixed, mid), worst


def tutorial_rays(model, fields, scx, scz, worst, what):
    """(13e) K2 and K3 on the inputs of the facade's
    ``find_all_TTF_rays(subgrid_size=9)``: the receivers' fields
    ``fields`` (float32, as the facade solved them), the three pairs of
    the upper triangle and the facade's default knobs (the crossing
    walk, no relaxation wave, bilinear field samples), against the
    twins' march and ray times in float32 and float64, to the
    tolerances stated at the top.  The differences go into ``worst``."""
    pairs = np.triu(np.ones((3, 3)), k=1)
    for m, dt in ((model, torch.float32), (as_float64(model), torch.float64)):
        mat_flat, tidx, src, rec, spec, final_cross, fast = march_inputs(
            m, dict(), 9, scx, scz, pairs, TUTORIAL_DNX)
        args = (m, mat_flat, fields.to(dt), tidx, src, rec, spec, fast)
        _, want, _ = plain_march(args)
        label = f"(13e) {what}, {str(dt)[6:]}"
        merge_worst(worst, march_vs_twin(args, want, final_cross, dt, label))
        merge_worst(worst, check_k3(
            m, mat_flat, *want[:3], spec.s, final_cross, dt, label,
            iters=(0,), scorers=K3_SCORERS[1:2], single_waves=False))


def phase_tutorial(device, ray_worst):
    """(13) The tutorial notebook's calls, in the order of its cells (1-4:
    the gradient model, ``update``, the ``sources`` mask,
    ``find_all_TTF_rays(subgrid_size=9)`` and ``ray_path``; 5: the
    curves, ``add_materials`` and the 45 degree table model; 6: the
    velpn = 0 Christoffel model with ``stif_den``), through ALI_FMM on the
    card at the notebook's sizes; the plots are left out (the card's host
    has no matplotlib).  (13a) the gradient field against the analytic
    time; (13b) the masked call; (13c) the rays between the transducers
    against the analytic surface time and the straight path; (13d) the
    table and the Christoffel models' fields against each other, and the
    Christoffel model's rays; (13e) the kernels at the tutorial's shapes
    against their twins (K1 on the gradient model's stages, and at the
    final shape on the rays' receivers and the 45 degree table and
    Christoffel models; K2 and K3 on the rays of the gradient and the
    Christoffel models, their differences merged into ``ray_worst``),
    and K1 warm at 3 x 201 x 201 and 2 x 201 x 201 beside its bound."""
    import alifmm_tpu_torch
    from alifmm_tpu_torch import solver
    from alifmm_tpu_torch.ops import cuda_sweep

    t_phase = time.perf_counter()
    alifmm_tpu_torch.tqdm_disable = True
    n, dnx = TUTORIAL_N, TUTORIAL_DNX
    veln, velpn, vel_map, scx, scz = tutorial_arrays()
    fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, scx, scz, dnx=dnx,
                                  device=device)
    # the gradient model as the facade builds it, on its default tables
    # (13d's add_materials replaces them)
    model = fm._make_model(veln, velpn, vel_map, None)
    rec = dict(calls={})

    # 13a: cell 5, fm.update
    fields, rec["calls"]["update"] = tutorial_call(
        "update (3 sources)", lambda: fm.update(veln, velpn, vel_map))
    check(fields.shape == (3, n, n) and bool(np.isfinite(fields).all()),
          f"tutorial fields: shape {fields.shape} or not finite")
    want, r2 = gradient_time(scx)
    far = r2 > (TUTORIAL_NEAR * dnx) ** 2
    err = [(float(r.max()), float(r.mean())) for r in
           (np.abs(fields[k] - want[k])[far[k]] / want[k][far[k]]
            for k in range(3))]
    bound = tuple(j + m for j, m in zip(TUTORIAL_JAX_ERROR,
                                        TUTORIAL_F32_MARGIN))
    log("  (13a) gradient field against the analytic time (points more "
        f"than {TUTORIAL_NEAR} cells from the source), max / mean rel by "
        "source: " + ", ".join(f"{a:.4e} / {b:.4e}" for a, b in err)
        + f"; bound {bound[0]:.4e} / {bound[1]:.4e} (JAX "
        f"{TUTORIAL_JAX_ERROR[0]:.4e} / {TUTORIAL_JAX_ERROR[1]:.4e} plus "
        "the float32 margin)")
    check(max(e[0] for e in err) <= bound[0]
          and max(e[1] for e in err) <= bound[1],
          "(13a) the gradient field is further from the analytic time than "
          "the JAX package's plus the float32 margin")
    rec["analytic"] = dict(max=[e[0] for e in err], mean=[e[1] for e in err],
                           bound=list(bound))

    # 13b: cell 7, the sources mask
    mask = np.array([1, 0, 1])
    some, rec["calls"]["update_masked"] = tutorial_call(
        "update with sources [1, 0, 1]",
        lambda: fm.update(veln, velpn, vel_map, sources=mask))
    check(bool((some[1] == 0).all()), "(13b) the masked field is not zero")
    tol = solver.SolveConfig().rel_tol
    d = float(np.abs(some[[0, 2]] - fields[[0, 2]]).max())
    scale = float(fields[[0, 2]].max())
    log(f"  (13b) masked field all zeros; the other two against the "
        f"unmasked call max abs {d:.4e} s (the final stop allows {tol} x "
        f"{scale:.4e} s)")
    check(d <= tol * scale, "(13b) the masked call's fields differ from the "
          "unmasked call's beyond the final stage's stop")
    rec["masked_max_abs"] = d

    # 13c: cell 9, the rays between the three transducers
    times, rec["calls"]["find_all_TTF_rays"] = tutorial_call(
        "find_all_TTF_rays(subgrid_size=9)",
        lambda: fm.find_all_TTF_rays(veln, velpn, vel_map, subgrid_size=9),
        rays=True)
    pairs = [(0, 1), (0, 2), (1, 2)]
    got = np.array([times[i, j] for i, j in pairs])
    dx = np.array([scx[j] - scx[i] for i, j in pairs])
    analytic, straight = surface_time(dx), dx / TUTORIAL_V0
    log("  (13c) ray times (us) against the analytic surface time and the "
        "straight path: " + ", ".join(
            f"{i}-{j} {t * 1e6:.4f} / {a * 1e6:.4f} / {s * 1e6:.4f}"
            for (i, j), t, a, s in zip(pairs, got, analytic, straight)))
    check(bool(np.isfinite(got).all()) and bool((got > 0).all()),
          "(13c) ray times not finite and positive")
    rel = np.abs(got - analytic) / analytic
    check(bool((rel <= TUTORIAL_RAY_TOL).all()),
          f"(13c) ray times off the analytic time by {rel.max():.3e}")
    over = (got - straight) / straight
    check(bool((over <= TUTORIAL_STRAIGHT_TOL).all()),
          f"(13c) a ray time above the straight path's by {over.max():.3e}")
    for i, j in pairs:
        rx, ry = fm.ray_path(i, j)
        check(rx is not None and bool(np.isfinite(rx).all())
              and bool(np.isfinite(ry).all()), f"ray_path({i}, {j})")
    rec["rays"] = dict(times=got.tolist(), analytic=analytic.tolist(),
                       max_rel=float(rel.max()), over_straight=float(
                           over.max()))

    # 13d: cells 11-12 (curves, add_materials, the 45 degree table model)
    # and 14 (the velpn = 0 Christoffel model)
    c22, c23, c33, c44, rho = TUTORIAL_STIFF
    curve = fm.generate_group_vel(c22, c23, c33, c44, rho, plot=False)
    check(curve.shape == (361,) and bool(np.isfinite(curve).all()),
          "generate_group_vel")
    fm.add_materials(np.array([c22, c23, c33, c44, rho]))
    veln_a = 45.0 * np.ones((n, n))
    velpn_a = np.ones((n, n), dtype=int)
    vel_map_a = np.ones((n, n))
    fields_a, rec["calls"]["update_table_45"] = tutorial_call(
        "update, 45 degree table model",
        lambda: fm.update(veln_a, velpn_a, vel_map_a))
    stif_den = np.zeros((n, n, 5), dtype=np.int64)
    stif_den[:, :] = [263000, 148000, 216000, 129000, 8100]
    velpn_s = np.zeros((n, n), dtype=int)
    fm_s = alifmm_tpu_torch.ALI_FMM(veln_a, velpn_s, vel_map_a, scx, scz,
                                    stif_den=stif_den, dnx=dnx, device=device)
    times_s, rec["calls"]["find_all_TTF_rays_christoffel"] = tutorial_call(
        "find_all_TTF_rays(subgrid_size=9), Christoffel model",
        lambda: fm_s.find_all_TTF_rays(veln_a, velpn_s, vel_map_a,
                                       stif_den=stif_den, subgrid_size=9),
        rays=True)
    fields_s, rec["calls"]["update_christoffel"] = tutorial_call(
        "update, Christoffel model",
        lambda: fm_s.update(veln_a, velpn_s, vel_map_a, stif_den=stif_den))
    known = fields_s > 0
    rel_ts = float((np.abs(fields_a - fields_s)[known]
                    / fields_s[known]).max())
    got_s = np.array([times_s[i, j] for i, j in pairs])
    log(f"  (13d) the table and the Christoffel models' fields: max rel "
        f"{rel_ts:.4e} (bound {TUTORIAL_MODELS_TOL}); Christoffel ray times "
        "(us) " + ", ".join(f"{i}-{j} {t * 1e6:.4f}"
                            for (i, j), t in zip(pairs, got_s)))
    check(bool(np.isfinite(fields_a).all()) and bool(np.isfinite(
        fields_s).all()), "(13d) the 45 degree fields are not finite")
    check(rel_ts <= TUTORIAL_MODELS_TOL, "(13d) the table and the "
          "Christoffel models' fields differ")
    check(bool(np.isfinite(got_s).all()) and bool((got_s > 0).all()),
          "(13d) Christoffel ray times not finite and positive")
    rec["table_vs_christoffel_max_rel"] = rel_ts
    rec["christoffel_times"] = got_s.tolist()

    # 13e: the kernels against their twins at the tutorial's shapes, then
    # K1 timed at the gradient model's final shape, 3 and 2 sources
    k1_worst = []
    finals = []
    for sel, every in (([0, 1, 2], True), ([1, 2], False)):
        final, e = tutorial_k1(model, scx, scz, sel, every, "gradient model")
        finals.append(final)
        k1_worst.append(e)
    model_a = fm._make_model(veln_a, velpn_a, vel_map_a, None)
    model_s = fm_s._make_model(veln_a, velpn_s, vel_map_a, stif_den)
    for m, what in ((model_a, "45 degree table model"),
                    (model_s, "Christoffel model")):
        k1_worst.append(tutorial_k1(m, scx, scz, [0, 1, 2], False, what)[1])
    for m, f, what in ((model, fm, "gradient model"),
                       (model_s, fm_s, "Christoffel model")):
        receivers = f._solve_fields(m, f.scx[[1, 2]], f.scz[[1, 2]], 1)
        tutorial_rays(m, receivers, scx, scz, ray_worst, what)
    rec["k1"] = []
    for m, tt, fx, want in finals:
        B = tt.shape[0]
        packed = cuda_sweep.pack_model(m)
        ms, out = time_k1(tt, fx, packed)
        same = torch.equal(out, want)
        log(f"  (13e) K1's timed pass at {B} x {n} x {n} equal to the "
            f"twin's bit for bit: {same}")
        check(same, f"(13e) K1's timed pass at {B} x {n} x {n} differs from "
              "the twin's")
        b, by = bound_ms(tt, fx, packed)
        C, G = cuda_sweep.launch_config(B, n, n, cuda_sweep._sm_count(
            tt.device))
        log(f"  (13e) K1 at {B} x {n} x {n}: {ms:.4f} ms per pass at "
            f"C={C} G={G}; bound {b:.4f} ms ({by}), share {b / ms:.4f}")
        rec["k1"].append(dict(shape=[B, n, n], ms=ms, bound_ms=b,
                              bound_by=by, share=b / ms, cluster=C, lanes=G))
    rec["k1_max_abs_err"] = max(k1_worst)
    rec["final_stage"] = finals[0][:3]  # for phase 14d; not in the JSON
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {rec['seconds']:.1f} s")
    return rec


# --------------------------------------------------------------------- #
# Phase 14: K1's other forms (csrc/sweep_forms.cu)
# --------------------------------------------------------------------- #

# (14a) the forms' passes held to the graphed twin: (name, gs_pass
# keywords, replace); every parallel-in-block form on 48 x 56 (S = 56, so
# a z-sweep's reverse blocks start with 8 padding lines), two on the
# other cases
OPERATOR_FORMS = (("fd_only min", dict(use_ali=False), False),
                  ("fd_only replace", dict(use_ali=False), True),
                  ("fd_free replace", dict(use_fd=False), True))
BLOCK_FORMS = tuple(
    (f"block B={b} J={j} {'ali' if ali else 'fd'} "
     f"{'replace' if rep else 'min'}",
     dict(block=b, inner=j, inner_use_ali=ali), rep)
    for b in (4, 8) for j in (1, 2, 4) for ali in (False, True)
    for rep in (False, True))
SOME_BLOCK_FORMS = tuple(f for f in BLOCK_FORMS if f[0] in (
    "block B=4 J=2 fd min", "block B=8 J=4 ali replace"))
FORM_CASES = {"48x56": OPERATOR_FORMS + BLOCK_FORMS,
              "37x131": OPERATOR_FORMS + SOME_BLOCK_FORMS,
              "patches 109x109": OPERATOR_FORMS + SOME_BLOCK_FORMS,
              "tie-heavy isotropic 64x64": OPERATOR_FORMS + SOME_BLOCK_FORMS}
# (14a) the two-loop fixpoints on 48 x 56, float64
FORM_FIXPOINTS = {"phase1_use_ali=False": dict(phase1_use_ali=False),
                  "polish_use_fd=False": dict(polish_use_fd=False,
                                              max_polish_passes=6),
                  "inner=2, block=4": dict(inner=2, block=4)}
# (14b) the weld slice in each form (the weld's budgets, SOLVE_KW, with
# these fields replaced), and the form kernel each must launch
FORM_SLICES = {
    "final_polish_fd=False": (dict(final_polish_fd=False), "k1_fd_free"),
    "use_ali=False": (dict(use_ali=False), "k1_fd_only"),
    "phase1_use_ali=False": (dict(phase1_use_ali=False), "k1_fd_only"),
    "sweep_inner=4, patch_inner=4": (dict(sweep_inner=4, patch_inner=4,
                                          sweep_block=8, patch_block=4),
                                     "k1_block_fd"),
    "multigrid=True": (dict(multigrid=True), None),
}


def form_kwargs(form):
    """gs_pass keywords of a ``sweep.Form``."""
    return dict(block=form.block, inner=form.inner,
                inner_use_ali=form.use_ali, use_ali=form.use_ali,
                use_fd=form.use_fd)


def check_form_pass(model, tt, fixed, kw, replace, what):
    """One pass of a form: the form kernel at AUTO's launch shapes against
    the graphed twin, max abs 0 (delta and scale equal too).  Returns the
    largest difference."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    want = sweep.gs_pass(tt, model, fixed, replace=replace, graphed=True,
                         **kw)
    dp, sp = sweep.delta_scale(want, tt)
    packed = cuda_sweep.pack_model(model)
    B = tt.shape[0]
    form = sweep.pass_form(**kw)
    worst = 0.0
    for cluster, lanes in AUTO:
        C, G = cuda_sweep.launch_config(B, *tt.shape[1:], cuda_sweep._sm_count(
            tt.device), cluster, lanes)
        got, dk, sk = cuda_sweep._launch(tt, fixed, packed,
                                         np.full(B, replace),
                                         np.ones(B, bool), C, G, form=form)
        e = float((got - want).abs().max())
        same = torch.equal(dk, dp) and torch.equal(sk, sp)
        log(f"  {what} C={C} G={G}: max abs {e:.3e}, delta and scale equal "
            f"{same}")
        check(e == 0.0 and same, f"{what} C={C} G={G}: the form kernel "
              f"differs from its twin")
        worst = max(worst, e)
    return worst


def twin_run(model, fixed, graphed=True):
    """The ``split_pass`` runner on the twin (graphed on the card)."""
    from alifmm_tpu_torch.ops import sweep

    def run(t, rep, act, form):
        return sweep.plain_pass(t, model, fixed, rep, act, graphed=graphed,
                                form=form)
    return run


def phase_forms_vs_plain(device, dtypes):
    """(14a) K1's forms against the graphed twin, max abs 0, in ``dtypes``:
    the operator forms (FD-only min and replace, FD-free replace) and the
    parallel-in-block sweeps (every B in 4, 8, J in 1, 2, 4, inner
    operator and accumulation on 48 x 56, two on the others) on
    ``FORM_CASES``; a pass whose sources are split between phase 1 and
    the polish (per-source forms); with float64 the two-loop fixpoints on
    48 x 56 with equal pass counts.  Phase 3's process runs float64, the
    main process float32 while it waits for it."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    t_phase = time.perf_counter()
    worst = 0.0
    for dtype in dtypes:
        dname = str(dtype).replace("torch.", "")
        for case, forms in FORM_CASES.items():
            model, tt, fixed = PASS_CASES[case][0](dtype, device)
            packed = cuda_sweep.pack_model(model)
            B = tt.shape[0]
            mid = tt
            for _ in range(2):  # K1's default form, equal to its twin
                mid, _, _ = cuda_sweep._launch(mid, fixed, packed,
                                               np.zeros(B, bool),
                                               np.ones(B, bool))
            t0 = time.perf_counter()
            for name, kw, rep in forms:
                worst = max(worst, check_form_pass(
                    model, mid if rep else tt, fixed, kw, rep,
                    f"(14a) {case} {name} {dname}"))
            log(f"  (14a) {case} {dname}: {len(forms)} forms in "
                f"{time.perf_counter() - t0:.1f} s")
        # one pass holding sources of both phases, each with its form
        model, tt, fixed = PASS_CASES["48x56"][0](dtype, device)
        rep, act = np.array([False, True, False]), np.ones(3, bool)
        for kw in (dict(phase1_use_ali=False), dict(inner=2, block=4)):
            forms = sweep.phase_forms(**kw)
            want = sweep.split_pass(tt, rep, act, forms,
                                    twin_run(model, fixed))
            got = sweep.split_pass(
                tt, rep, act, forms,
                lambda t, r, a, f: cuda_sweep.sweep_pass(t, model, fixed, r,
                                                         a, form=f))
            e = float((got[0] - want[0]).abs().max())
            log(f"  (14a) 48x56 {dname}, sources 0 and 2 in phase 1, 1 in "
                f"the polish, {kw}: max abs {e:.3e}")
            check(e == 0.0 and np.array_equal(got[1], want[1]),
                  f"(14a) a pass of mixed phases ({kw}) differs")
            worst = max(worst, e)
    fixpoints = {}
    if torch.float64 not in dtypes:
        secs = time.perf_counter() - t_phase
        log(f"  phase 14a ({dtypes}): {secs:.1f} s, max abs {worst:.3e}")
        return dict(max_abs_err=worst, fixpoints=fixpoints, seconds=secs)
    # the two-loop fixpoints, float64
    model, tt, fixed = PASS_CASES["48x56"][0](torch.float64, device)
    budget = dict(rel_tol=1e-3, max_passes=6, polish_passes=2)
    for name, kw in FORM_FIXPOINTS.items():
        got, info_k = cuda_sweep.solve_fixpoint(tt, model, fixed, **budget,
                                                **kw)
        forms = sweep.phase_forms(kw.get("block", 1), kw.get("inner", 0),
                                  True, kw.get("phase1_use_ali"),
                                  kw.get("polish_use_fd", True))
        run = twin_run(model, fixed)
        want, info_p = sweep.two_phase(
            tt, lambda t, r, a: sweep.split_pass(t, r, a, forms, run), False,
            budget["rel_tol"], budget["max_passes"], 2,
            budget["polish_passes"], kw.get("max_polish_passes"),
            sweep.two_loop(kw.get("inner", 0), True,
                           kw.get("phase1_use_ali"),
                           kw.get("polish_use_fd", True)))
        e = float((got - want).abs().max())
        log(f"  (14a) fixpoint {name} float64: max abs {e:.3e}; passes "
            f"kernel {info_k} twin {info_p}")
        check(e == 0.0 and info_k == info_p,
              f"(14a) the {name} fixpoint differs from its twin's")
        fixpoints[name] = dict(passes=info_k.passes,
                               converged=info_k.converged)
        worst = max(worst, e)
    secs = time.perf_counter() - t_phase
    log(f"  phase 14a ({dtypes}): {secs:.1f} s, max abs {worst:.3e}")
    return dict(max_abs_err=worst, fixpoints=fixpoints, seconds=secs)


def rel_dev(got, want):
    """(max, mean) relative deviation of ``got`` from ``want``."""
    r = ((got.double() - want.double()).abs()
         / want.double().abs().clamp_min(1e-30))
    return float(r.max()), float(r.mean())


def form_slice(inputs, cfg, what, ttfs0, times0, form_key):
    """A weld slice of ``cfg``: a warm-up run, then a timed one with every
    count set to 0 just before it: finite fields, every ray time finite
    and positive and every ray arrived or, as phase 11c allows, finished
    where its next plane left the grid within two steps of its receiver
    (``qsv_search_ends``), one K2 and one K3, no plain pass or step, and
    the form kernel ``form_key`` launched.  Returns its record and ray
    times."""
    import warnings

    from alifmm_tpu_torch.ops.stencils import INF

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_slice(inputs, cfg=cfg)
    warned = [str(w.message) for w in caught]
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ttfs, info, out, (t_solve, t_rays, wall) = run_slice(inputs, rec, cfg)
    counts = read_counts()
    bx, by, lengths, times, reason = out
    k1 = {k: v for k, v in counts.items()
          if k == "sweep_pass" or k.startswith("k1_")}
    f_dev, r_dev = rel_dev(ttfs, ttfs0), rel_dev(times, times0)
    log(f"  (14b) {what}: {wall:.4f} s (solve {t_solve:.4f} s, rays "
        f"{t_rays:.4f} s; stages " + ", ".join(f"{n} {t:.4f} s"
                                               for n, t in stages)
        + f"); final passes {info.passes} converged {info.converged}; K1 "
        f"launches by form {k1}; fields against the default max / mean rel "
        f"{f_dev[0]:.4e} / {f_dev[1]:.4e}, ray times {r_dev[0]:.4e} / "
        f"{r_dev[1]:.4e}")
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          f"(14b) {what}: fields not finite everywhere")
    ends = qsv_search_ends(out, inputs[4], f"(14b) {what}")
    check(counts["march"] == 1 and counts["relax_times"] == 1
          and counts["plain_passes"] == 0 and counts["plain_steps"] == 0,
          f"(14b) {what}: launches {counts}")
    check(sum(k1.values()) > 0 and (form_key is None or counts[form_key] > 0),
          f"(14b) {what}: the form kernel {form_key} was not launched")
    return dict(wall=wall, solve=t_solve, rays=t_rays, stages=stages,
                passes=info.passes, converged=info.converged, k1=k1,
                fields_vs_default=f_dev, times_vs_default=r_dev,
                ray_ends=ends, warnings=warned), times


def phase_forms_weld(inputs, ttfs0, times0, device):
    """(14b) the weld slice at full width (31 fields of 424 x 500, 961
    rays, float32, phase 6's budgets and knobs) in each form of
    ``FORM_SLICES`` (``form_slice``; the multigrid start must warn), then
    ``ALI_FMM(solve_opts=final_polish_fd=False)`` timed, its times equal
    to the direct path's."""
    import warnings

    import alifmm_tpu_torch
    from alifmm_tpu_torch import solver, weld_data

    out = {}
    direct = {}
    for what, (kw, key) in FORM_SLICES.items():
        cfg = solver.SolveConfig(**{**SOLVE_KW, **kw})
        out[what], direct[what] = form_slice(inputs, cfg, what, ttfs0,
                                             times0, key)
        if cfg.multigrid:
            check(any("multigrid is experimental" in w
                      for w in out[what]["warnings"]),
                  "(14b) the multigrid start did not warn")
    alifmm_tpu_torch.tqdm_disable = True
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    fm = alifmm_tpu_torch.ALI_FMM(
        veln, velpn, vel_map, sx, sy, stif_den=stif, dnx=dnx,
        ray_opts=RAY_OPTS, solve_opts=dict(SOLVE_KW, final_polish_fd=False))

    def call():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            tmat = fm.find_all_TTF_rays_parallel(
                veln, velpn, vel_map, stif_den=stif, trans_pairs=pairs,
                n_threads=8)
            torch.cuda.synchronize()
            return tmat, time.perf_counter() - t0

    call()
    reset_counts()
    tmat, wall = call()
    counts = read_counts()
    pi, pj = np.nonzero(pairs == 1)
    got = tmat[pi, pj]
    want = direct["final_polish_fd=False"].double().cpu().numpy()
    rel = float((np.abs(got - want) / want).max())
    log(f"  (14b) ALI_FMM(solve_opts=final_polish_fd=False): warm call "
        f"{wall:.4f} s; launches {counts}; times against the direct path's "
        f"max rel {rel:.3e}")
    check(counts["k1_fd_free"] > 0 and counts["march"] == 1
          and counts["relax_times"] == 1 and counts["plain_passes"] == 0,
          f"(14b) the facade's FD-free polish run: launches {counts}")
    check(rel <= 1e-6, "(14b) the facade's times differ from the direct "
          "path's")
    out["facade final_polish_fd=False"] = dict(wall=wall, counts=counts,
                                               vs_direct_max_rel=rel)
    return out


def phase_forms_qsv(inputs, qsv_ttfs, qp_times, device):
    """(14c) the qSV weld under ``for_mode("qsv", phase1_use_ali=False)``
    (an FD envelope, then the ALI polish), directly: a warm-up run and a
    timed one; its passes and its fields' deviation from 11c's.  Every ray
    time is finite and positive and within 11c's bounds of the qP time.
    11c's arrival rules (the weld knobs' search arrives or ends at the
    grid's edge near its receiver; auto lands every ray one of its tracers
    lands) do not hold on this field: the search truncates ray 143 far
    from its receiver, and auto takes the search's truncated rays where
    its certificate rejects the descent's (PERF.md, PR 12).  They are
    recorded, not held, and the rays that did not arrive are saved with
    their fields to QSV_FD_RAYS_FILE for tests/qsv_ray_records.py, which
    traces them with the JAX package."""
    from alifmm_tpu_torch import solver
    from alifmm_tpu_torch.ops.stencils import INF

    model = qsv_weld_model(torch.float32, device)
    q_inputs = (model,) + tuple(inputs[1:])
    cfg = solver.SolveConfig.for_mode("qsv", phase1_use_ali=False)
    run_slice(q_inputs, cfg=cfg)
    reset_counts()
    ttfs, info, out, (t_solve, t_rays, wall) = run_slice(q_inputs, cfg=cfg)
    counts = read_counts()
    what = "(14c) qSV weld, phase1_use_ali=False"
    f_dev = rel_dev(ttfs, qsv_ttfs)
    log(f"  {what}: {wall:.4f} s (solve {t_solve:.4f} s, rays {t_rays:.4f} "
        f"s); final passes {info.passes} converged {info.converged}; "
        f"launches {counts}; fields against 11c's max / mean rel "
        f"{f_dev[0]:.4e} / {f_dev[1]:.4e}")
    check(counts["k1_fd_only"] > 0, f"{what}: no FD-only launch")
    check_tracer_counts(counts, "search", 0, what)
    check(bool(torch.isfinite(ttfs).all()) and bool((ttfs < INF * 0.5).all()),
          f"{what}: fields not finite everywhere")
    search = qsv_search_ends(out, q_inputs[4], what, edge_rule=False)
    auto_times, auto = qsv_auto_arrival(model, ttfs, q_inputs,
                                        f"{what}, auto", lands=False)
    save_not_arrived(ttfs, q_inputs, out, search["early"], auto_times,
                     auto["not_arrived"], QSV_FD_RAYS_FILE)
    return dict(wall=wall, solve=t_solve, rays=t_rays, passes=info.passes,
                converged=info.converged, counts=counts,
                fields_vs_11c=f_dev, search=search, auto=auto,
                over_qp=check_over_qp(out[3], qp_times, what))


def time_form(model, tt, fixed, packed, form, replace, what):
    """A form's pass timed warm (CUDA events) beside its bound, the timed
    pass equal to the graphed twin's (timed on the host clock)."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    ms, got = time_k1(tt, fixed, packed, form=form, replace=replace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sweep.gs_pass(tt, model, fixed, replace=replace, graphed=True,
                         **form_kwargs(form))
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    e = float((got - want).abs().max())
    bound, by = bound_ms(tt, fixed, packed, form)
    B, Z, X = tt.shape
    C, G = cuda_sweep.launch_config(B, Z, X, cuda_sweep._sm_count(tt.device))
    log(f"  (14d) {what} at {B} x {Z} x {X}: {ms:.4f} ms per pass at C={C} "
        f"G={G}; bound {bound:.4f} ms ({by}), share {bound / ms:.4f}; "
        f"graphed twin {ms_p:.1f} ms, max abs {e:.3e}")
    check(e == 0.0, f"(14d) {what}: the timed pass differs from its twin")
    return dict(shape=[B, Z, X], ms=ms, plain_ms=ms_p, bound_ms=bound,
                bound_by=by, share=bound / ms, max_abs_err=e, cluster=C,
                lanes=G)


def phase_forms_timing(inputs, tutorial_final):
    """(14d) each form timed warm beside its bound and K1's default pass:
    at the weld's final stage (31 x 424 x 500, float32) FD-only, FD-free
    (a replace pass on K1's min pass) and the parallel-in-block FD sweeps
    with B = 8 and J = 2, 4; at the tutorial's latency-bound 3 x 201 x
    201 (the gradient model's final stage) the parallel sweeps with J = 2
    and 4 beside the strict order."""
    from alifmm_tpu_torch.ops import cuda_sweep, sweep

    out = {}
    _, model, tt0, fixed = stage_inputs(inputs)[-1]
    packed = cuda_sweep.pack_model(model)
    ms0, mid = time_k1(tt0, fixed, packed)
    out["default 31x424x500"] = dict(ms=ms0)
    log(f"  (14d) K1's default form at 31 x 424 x 500: {ms0:.4f} ms a pass")
    for what, form, rep, start in (
            ("fd_only min", sweep.Form(False, True), False, tt0),
            ("fd_free replace", sweep.Form(True, False), True, mid),
            ("block B=8 J=2 fd min", sweep.Form(False, True, 8, 2), False,
             tt0),
            ("block B=8 J=4 fd min", sweep.Form(False, True, 8, 4), False,
             tt0)):
        out[f"{what} 31x424x500"] = time_form(model, start, fixed, packed,
                                              form, rep, what)
    m, tt, fx = tutorial_final
    packed = cuda_sweep.pack_model(m)
    ms0, _ = time_k1(tt, fx, packed)
    out["default 3x201x201"] = dict(ms=ms0)
    log(f"  (14d) K1's default form at 3 x 201 x 201: {ms0:.4f} ms a pass")
    for j in (2, 4):
        what = f"block B=8 J={j} fd min"
        out[f"{what} 3x201x201"] = time_form(
            m, tt, fx, packed, sweep.Form(False, True, 8, j), False, what)
    return out


# --------------------------------------------------------------------- #
# Phase 15: BASELINE's fifth configuration (qSV/qSH shear modes on a large
# grid, sharded with halo exchange): the fine weld and the shear welds on
# the halo path, and qSH solves
# --------------------------------------------------------------------- #

def halo_solve(model, inputs, kind, device, cfg, subgrid_size=1,
               progress=None):
    """solve_ttf_halo of ``inputs``' sources on ``model`` over
    ``virtual_mesh(kind)``, with every count set to 0 just before it:
    (fields, SolveInfo, seconds, counts)."""
    from alifmm_tpu_torch.parallel import shard

    mesh, axis = virtual_mesh(device, kind)
    scx, scz = inputs[1:3]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, info = shard.solve_ttf_halo(model, scx, scz, mesh, axis=axis,
                                     subgrid_size=subgrid_size, cfg=cfg,
                                     return_info=True, progress=progress)
    torch.cuda.synchronize()
    return got, info, time.perf_counter() - t0, read_counts()


def halo_rounds(counts, kind, what):
    """The halo solve's rounds from its K5 launches (ROUND_LAUNCHES a
    round), after checking that it launched K1 for its patch stages, whole
    rounds of K5 and no plain twin."""
    per, n = ROUND_LAUNCHES[kind], counts["slab_sweep"]
    check(counts["sweep_pass"] > 0 and n > 0 and n % per == 0,
          f"{what}: {counts['sweep_pass']} K1 and {n} K5 launches (whole "
          f"rounds of {per} expected)")
    check(counts["plain_passes"] == 0, f"{what} ran the plain sweep pass "
          f"on the card")
    return n // per


def field_gap(got, want):
    """The largest |got - want| over points known in both, source by
    source (``want`` may lie on the host; each source of ``got`` is copied
    there in turn); inf where the known points differ."""
    from alifmm_tpu_torch.ops.stencils import INF

    check(tuple(got.shape) == tuple(want.shape),
          f"field shape {tuple(got.shape)}, not {tuple(want.shape)}")
    worst = 0.0
    for b in range(want.shape[0]):
        g, w = got[b].to(want.device), want[b]
        if torch.equal(g, w):
            continue
        if not torch.equal(g < INF * 0.5, w < INF * 0.5):
            return float("inf")
        worst = max(worst, float(known_gap(g, w).max()))
    return worst


def check_halo_equal(got, info, want, want_info, what):
    """Max abs 0 from the one-device fields, equal passes and converged."""
    gap = field_gap(got, want)
    log(f"  {what}: final passes {info.passes} converged {info.converged} "
        f"(one device: {want_info[0]}, {want_info[1]}); max abs from the "
        f"one-device fields {gap}")
    check(gap == 0.0 and (info.passes, info.converged) == tuple(want_info),
          f"{what} differs from the one-device solve (max abs {gap}, "
          f"passes {info.passes} against {want_info[0]}, converged "
          f"{info.converged} against {want_info[1]})")
    return gap


def phase_halo_fine(inputs, fine, k1_fine_ms, device):
    """(15a) the fine weld (s = 9: 31 fields of 3808 x 4492, float32,
    phase 9's budgets) through solve_ttf_halo on four z slabs of virtual
    ranks: max abs 0 from phase 9's one-device fields (kept on the host),
    equal passes and converged, its peak device memory and its K5
    launches (whole rounds); the 961 nearest-point rays through the halo
    fields equal to phase 9's; then one warm solve timed with its stage
    split, its rounds beside K1's fine pass (phase 10); then K5 at the
    fine final shape (the injected state of phase 10): one slab z-sweep,
    the refreshed x-sweep of the four slabs in one launch (c = 2, G = 4)
    and one round, each timed warm beside its bound."""
    from alifmm_tpu_torch import rays, solver, weld_data
    from alifmm_tpu_torch.ops import cuda_sweep
    from alifmm_tpu_torch.parallel import shard

    model, _, _, src_xy, rec_xy, tidx = inputs
    cfg = solver.SolveConfig(**SOLVE_KW)
    s = weld_data.SUBGRID
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, info, first, counts = halo_solve(model, inputs, "1d", device, cfg, s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rounds = halo_rounds(counts, "1d", "the fine weld's halo solve")
    log(f"  fine weld on four slabs: {first:.4f} s (first solve), {rounds} "
        f"rounds, launches {counts}, peak device memory {peak:.3f} GB")
    gap = check_halo_equal(got, info, fine["ttfs"],
                           (fine["passes"], fine["converged"]),
                           "the fine weld on four slabs")
    reset_counts()
    out = rays.trace_rays(model, got, tidx, src_xy, rec_xy, s, mode="grid",
                          return_reason=True, **RAY_OPTS)
    r_counts = read_counts()
    check(r_counts["march"] == 1 and r_counts["relax_times"] == 1
          and r_counts["plain_steps"] == 0, f"the fine halo fields' rays "
          f"launched {r_counts}")
    same = [torch.equal(a, b) for a, b in zip(out, fine["out"])]
    log(f"  the 961 nearest-point rays through the halo fields: times, "
        f"vertices, lengths and reasons equal to phase 9's: {same}")
    check(all(same), "the rays through the fine halo fields differ from "
          "phase 9's")
    del got, out
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    got, info2, wall, counts2 = halo_solve(model, inputs, "1d", device, cfg,
                                           s, rec)
    del got
    check(info2 == info and counts2["slab_sweep"] == counts["slab_sweep"],
          "the warm fine halo solve ran another schedule")
    final_s = stages[-1][1]
    solve_round_ms = final_s / rounds * 1e3
    log(f"  warm solve {wall:.4f} s: "
        + ", ".join(f"{n} {t:.4f} s" for n, t in stages)
        + f"; the final stage {solve_round_ms:.1f} ms a round "
        f"({solve_round_ms / k1_fine_ms:.3f} K1 fine passes of "
        f"{k1_fine_ms:.1f} ms)")
    # K5 at the fine final shape
    name, fmodel, tt0, fixed = fine_stage_inputs(inputs)[-1]
    grid, two_d = shard._halo_grid(*virtual_mesh(device, "1d"))
    h = shard._Halo(tt0, fmodel, fixed, grid, two_d, None, None)
    del tt0, fixed
    torch.cuda.empty_cache()
    h.exchange_z()
    k = (1, 0)
    z_ms = time_events(lambda: h.sweep([k], "z", False, False, False), 2)
    z_bound, z_by = slab_bound(h, [k])
    z_lay = h.kernels[(k,), "z"].layout
    slabs = tuple((iz, 0) for iz in range(h.nz))
    l0 = cuda_sweep.SLAB_LAUNCHES
    h.sweep(slabs, "x", False, False, True)
    n_x = cuda_sweep.SLAB_LAUNCHES - l0
    x_lay = h.kernels[slabs, "x"].layout
    check(n_x == 1 and tuple(x_lay) == (False, 4, 2, 4),
          f"the fine refreshed x-sweep took {n_x} K5 launches in {x_lay}, "
          f"not one in four blocks of c = 2, G = 4")
    x_ms = time_events(lambda: h.sweep(slabs, "x", False, False, True), 2)
    x_bound, x_by = slab_bound(h, slabs)
    l0 = cuda_sweep.SLAB_LAUNCHES
    r_ms = time_events(lambda: shard._halo_jacobi_block(h, 1, False), 2)
    per_round = (cuda_sweep.SLAB_LAUNCHES - l0) / 3
    r_bound, r_by = slab_bound(h, h.keys, sweeps=4)
    shape = list(h.t[k].shape)
    del h
    torch.cuda.empty_cache()
    check(per_round == ROUND_LAUNCHES["1d"], f"a fine halo round launched "
          f"K5 {per_round} times, not {ROUND_LAUNCHES['1d']}")
    log(f"  K5 at the fine final shape ({name}, slabs {shape}): one slab "
        f"z-sweep {z_ms:.3f} ms ({z_lay}), bound {z_bound:.4f} ms ({z_by}),"
        f" share {z_bound / z_ms:.4f}; the refreshed x-sweep of the four "
        f"slabs, one launch, {x_ms:.3f} ms ({x_lay}), bound {x_bound:.4f} "
        f"ms ({x_by}), share {x_bound / x_ms:.4f}; a round {r_ms:.1f} ms "
        f"({r_ms / k1_fine_ms:.3f} K1 fine passes), bound {r_bound:.4f} ms "
        f"({r_by}), share {r_bound / r_ms:.4f}, {per_round:g} K5 launches")
    return dict(first=first, wall=wall, stages=stages, final=final_s,
                passes=info.passes, converged=info.converged, rounds=rounds,
                launches=counts, k5_launches=counts["slab_sweep"],
                peak_gb=peak, max_abs=gap, rays_equal=all(same),
                solve_round_ms=solve_round_ms, k1_pass_ms=k1_fine_ms,
                slab_shape=shape,
                slab_z_sweep=dict(ms=z_ms, bound_ms=z_bound, bound_by=z_by,
                                  share=z_bound / z_ms,
                                  layout=z_lay._asdict()),
                refreshed_x_sweep=dict(ms=x_ms, bound_ms=x_bound,
                                       bound_by=x_by, share=x_bound / x_ms,
                                       launches=n_x,
                                       layout=x_lay._asdict()),
                round=dict(ms=r_ms, bound_ms=r_bound, bound_by=r_by,
                           share=r_bound / r_ms, k5_launches=per_round))


def phase_halo_qsv(inputs, qsv_ttfs, qsv_info, device):
    """(15b) the qSV weld (phase 11c's model and for_mode("qsv"), 31
    sources, float32) through solve_ttf_halo on four z slabs and on 2 x 2
    blocks: max abs 0 from phase 11c's one-device fields, equal passes and
    converged; seconds, rounds and K5 launches (K5's column mode 2 through
    whole solves)."""
    from alifmm_tpu_torch import solver

    model = qsv_weld_model(torch.float32, device)
    q_inputs = (model,) + tuple(inputs[1:])
    cfg = solver.SolveConfig.for_mode("qsv")
    out = {}
    for kind in ("1d", "2d"):
        got, info, wall, counts = halo_solve(model, q_inputs, kind, device,
                                             cfg)
        rounds = halo_rounds(counts, kind, f"the qSV weld on {kind}")
        log(f"  qSV weld on {kind}: {wall:.4f} s, {rounds} rounds, launches "
            f"{counts}")
        gap = check_halo_equal(got, info, qsv_ttfs, qsv_info,
                               f"the qSV weld on {kind}")
        out[kind] = dict(wall=wall, passes=info.passes,
                         converged=info.converged, rounds=rounds,
                         k5_launches=counts["slab_sweep"],
                         k1_launches=counts["sweep_pass"], max_abs=gap)
    return out


def phase_qsh(inputs, qp_times, device):
    """(15c) the qSH weld (the qSV weld's layout with the qSH pair of
    ``generate_mode_curves(*QSV_STIFF, c66=QSH_C66, mode="qSH")`` as
    column 2 and the 3240 m/s parent, for_mode("qsh"), 31 fields, 961
    rays, float32): directly (solve_ttf + the plane search with the weld's
    knobs; a warm-up run, then a timed one with every count set to 0 just
    before it), the auto tracer directly and through ALI_FMM(tracer=
    "auto") (likewise), and through solve_ttf_halo on four z slabs.
    Converged within the qsh budget, fields finite, every time finite and
    positive, the rays that do not arrive exactly those the JAX package
    does not land (QSH_SEARCH_EARLY, QSH_AUTO_LOST: phase 11c's rule; they
    are saved to QSH_RAYS_FILE for tests/qsv_ray_records.py), each qSH ray
    time within QSH_OVER_QP of the same pair's qP time (phase 6), no auto
    time above the descent's, the facade's times those of the direct auto
    trace, the halo fields max abs 0 from the direct ones with equal
    passes and converged."""
    import warnings

    import alifmm_tpu_torch
    from alifmm_tpu_torch import solver, weld_data
    from alifmm_tpu_torch.ops.stencils import INF

    model = qsv_weld_model(torch.float32, device, mode="qSH")
    q_inputs = (model,) + tuple(inputs[1:])
    cfg = solver.SolveConfig.for_mode("qsh")
    run_slice(q_inputs, cfg=cfg)
    stages = []

    def rec(stage, total, name, seconds):
        stages.append((name, seconds))

    reset_counts()
    ttfs, info, out, (t_solve, t_rays, wall) = run_slice(q_inputs, rec, cfg)
    counts = read_counts()
    log(f"  direct qSH weld slice warm wall clock {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s; "
        + ", ".join(f"{n} {t:.4f} s" for n, t in stages)
        + f"); final passes {info.passes} converged {info.converged}; "
        f"launches {counts}")
    check_tracer_counts(counts, "search", 0, "the direct qSH weld slice")
    check(info.converged and info.passes < cfg.final_max_passes,
          f"qSH weld: the final stage did not converge in "
          f"{cfg.final_max_passes} passes ({info.passes})")
    check(ttfs.shape == (31, 424, 500) and bool(torch.isfinite(ttfs).all())
          and bool((ttfs < INF * 0.5).all()),
          "qSH weld fields not finite everywhere")
    res = dict(wall=wall, solve=t_solve, rays=t_rays, stages=stages,
               passes=info.passes, converged=info.converged, counts=counts,
               search=qsv_search_ends(out, q_inputs[4], "qSH weld, search",
                                      edge_rule=False),
               over_qp=check_over_qp(out[3], qp_times, "qSH weld, direct",
                                     QSH_OVER_QP, "qSH"))
    auto_times, res["auto"] = qsv_auto_arrival(model, ttfs, q_inputs,
                                               "qSH weld, auto (direct)",
                                               lands=False)
    save_not_arrived(ttfs, q_inputs, out, res["search"]["early"],
                     auto_times, res["auto"]["not_arrived"], QSH_RAYS_FILE,
                     "qSH")
    early = tuple(r["ray"] for r in res["search"]["early"])
    lost = tuple(sorted(r["ray"] for r in res["auto"]["not_arrived"]))
    check(early == QSH_SEARCH_EARLY and lost == QSH_AUTO_LOST,
          f"qSH weld: the rays that do not arrive (search {early}, auto "
          f"{lost}) are not those the JAX package does not land "
          f"({QSH_SEARCH_EARLY}, {QSH_AUTO_LOST})")
    res["auto_over_qp"] = check_over_qp(auto_times, qp_times,
                                        "qSH weld, auto (direct)",
                                        QSH_OVER_QP, "qSH")
    alifmm_tpu_torch.tqdm_disable = True
    veln, velpn, vel_map = qsv_weld_arrays()
    _, _, _, _, sx, sy, pairs, dnx = weld_data.workload(0)
    g, p = qsv_tables(mode="qSH")
    fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy, group_vel=g,
                                  phase_vel=p, dnx=dnx,
                                  ray_opts={"tracer": "auto"},
                                  solve_opts=cfg)

    def call():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            tmat = fm.find_all_TTF_rays_parallel(veln, velpn, vel_map,
                                                 trans_pairs=pairs,
                                                 n_threads=8)
            torch.cuda.synchronize()
            return tmat, time.perf_counter() - t0

    call()
    reset_counts()
    tmat, f_wall = call()
    f_counts = read_counts()
    what = "qSH weld facade, tracer auto"
    check_tracer_counts(f_counts, "auto", f_counts["march"], what)
    pi, pj = np.nonzero(pairs == 1)
    got = tmat[pi, pj]
    want = auto_times.double().cpu().numpy()
    rel = float((np.abs(got - want) / want).max())
    log(f"  {what}: warm call {f_wall:.4f} s, counts {f_counts}; times "
        f"against the direct auto trace max rel {rel:.3e}")
    check(bool((np.isfinite(got) & (got > 0)).all()) and len(got) == 961
          and not tmat[pairs != 1].any() and rel <= 1e-6,
          f"{what}: times not finite and positive on exactly the 961 pairs, "
          f"or not the direct path's")
    res["facade_auto"] = dict(wall=f_wall, counts=f_counts,
                              vs_direct_max_rel=rel)
    got, hinfo, h_wall, h_counts = halo_solve(model, q_inputs, "1d", device,
                                              cfg)
    rounds = halo_rounds(h_counts, "1d", "the qSH weld on four slabs")
    log(f"  qSH weld on four slabs: {h_wall:.4f} s, {rounds} rounds, "
        f"launches {h_counts}")
    gap = check_halo_equal(got, hinfo, ttfs, (info.passes, info.converged),
                           "the qSH weld on four slabs")
    res["halo"] = dict(wall=h_wall, rounds=rounds, passes=hinfo.passes,
                       converged=hinfo.converged,
                       k5_launches=h_counts["slab_sweep"], max_abs=gap)
    return res


def phase_qsh_homogeneous(device):
    """(15d) homogeneous qSH (QSH_SHAPE, orientation 0, the qSH column
    everywhere, one interior source) with the full stage schedule and
    for_mode("qsh"), float32 and float64, against the closed-form
    elliptical first arrival (``qsh_homogeneous_time``): max and mean
    relative error over every point but the source within the JAX
    package's own error on the same model (``QSH_JAX_ERROR``, from
    tests/qsh_records.py) plus ``QSH_F32_MARGIN``."""
    from alifmm_tpu_torch import grid, solver

    g, p = qsv_tables(mode="qSH")
    want = qsh_homogeneous_time()
    sz, sx = QSH_SOURCE
    cfg = solver.SolveConfig.for_mode("qsh")
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = grid.make_model(*qsh_homogeneous_arrays(), None, g, p,
                                QSH_DNX, dtype=dtype, device=device)
        t0 = time.perf_counter()
        tt, info = solver.solve_ttf(model, torch.tensor([sx * QSH_DNX]),
                                    torch.tensor([sz * QSH_DNX]), 1, cfg,
                                    return_info=True)
        got = tt[0].double().cpu().numpy()
        sec = time.perf_counter() - t0
        mx, mean = qsh_errors(got, want)
        bound = [e + m for e, m in zip(QSH_JAX_ERROR, QSH_F32_MARGIN)]
        name = str(dtype).replace("torch.", "")
        log(f"  homogeneous qSH {QSH_SHAPE[0]}x{QSH_SHAPE[1]} {name}: rel "
            f"err max {mx:.5e} mean {mean:.5e} (JAX {QSH_JAX_ERROR[0]:.5e}, "
            f"{QSH_JAX_ERROR[1]:.5e}; bound {bound[0]:.5e}, "
            f"{bound[1]:.5e}); final passes {info.passes} converged "
            f"{info.converged}; {sec:.3f} s")
        check(bool(np.isfinite(got).all()) and info.converged,
              f"homogeneous qSH {name}: not finite or not converged")
        check(mx <= bound[0] and mean <= bound[1], f"homogeneous qSH {name}: "
              f"error beyond the JAX package's plus the margin")
        out[name] = dict(max=mx, mean=mean, passes=info.passes,
                         converged=info.converged, seconds=sec)
    return out



# K6 (csrc/planes.cu) against its twin, grid._np_fallback_slowness_planes
# run in float64 on the float64 casts of the same inputs: float32 planes
# within PLANES_MAX_ULP float32 ulps of the twin rounded to float32 (only
# tan, atan, cos and sin differ from numpy's, each by an ulp or two of
# float64), float64 planes within PLANES_RTOL_F64.
PLANES_MAX_ULP = 1
PLANES_RTOL_F64 = 1e-12
PLANES_CASES = ("weld", "tables", "random")


def _two_table_materials():
    """Group tables of two anisotropic table materials (columns 1 and 2,
    column 0 the angle), from stiffness in Pa, as tests/test_torch_model.py
    builds its table case."""
    from alifmm_tpu_torch import materials

    g = np.zeros((361, 3))
    g[:, 0] = np.arange(361)
    for m, c in enumerate([(263e9, 145e9, 216e9, 129e9, 7800.0),
                           (240e9, 120e9, 250e9, 110e9, 7600.0)]):
        g[:, m + 1] = materials.generate_group_vel_curve(*c)
    return g


def planes_case(name):
    """Host inputs (veln, velpn, vel_map, stif, group_tab, has_stif) of
    K6's cases: ``weld`` seed 0's 424 x 500 weld with the default tables
    (as ``weld_inputs`` builds it); ``tables`` the table case of
    tests/test_torch_model.py (non-integer orientations, two anisotropic
    table materials, no stiffness); ``random`` 48 x 56 with stiffness and
    table points mixed, orientations of every kind (non-integer, integer,
    half-integer so that round(45 - veln) ties, and within 0.01 degrees
    of an axis, where the Christoffel solve takes its axis branch) and
    stiffness rows varied point by point."""
    from alifmm_tpu_torch import materials, weld_data

    if name == "weld":
        veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
        return veln, velpn, vel_map, stif, materials.default_tables()[0], True
    if name == "tables":
        rng = np.random.default_rng(5)
        Z, X = 18, 22
        return (rng.uniform(0, 180, (Z, X)), rng.integers(1, 3, (Z, X)),
                rng.uniform(0.8, 1.2, (Z, X)), np.zeros((Z, X, 5)),
                _two_table_materials(), False)
    rng = np.random.default_rng(11)
    Z, X = 48, 56
    kind = rng.integers(0, 4, (Z, X))
    veln = np.select(
        [kind == 0, kind == 1, kind == 2],
        [rng.uniform(-400.0, 400.0, (Z, X)),
         rng.integers(-360, 361, (Z, X)).astype(float),
         rng.integers(-720, 721, (Z, X)) * 0.5],
        rng.integers(-8, 9, (Z, X)) * 45.0
        + rng.uniform(-0.012, 0.012, (Z, X)))
    velpn = rng.integers(0, 3, (Z, X))
    vel_map = np.where(velpn == 0, 1.0, rng.uniform(0.8, 1.2, (Z, X)))
    row = np.array([263000.0, 148000.0, 216000.0, 129000.0, 8100.0])
    stif = row * rng.uniform(0.9, 1.1, (Z, X, 5))
    return veln, velpn, vel_map, stif, _two_table_materials(), True


def planes_inputs(case, dtype, twin=None):
    """``case``'s inputs cast as make_model casts them (floats to
    ``dtype``, velpn to int32), and the twin's planes: the numpy function
    (``twin``, by default ``grid._np_fallback_slowness_planes``) in float64
    on the float64 casts of those inputs."""
    from alifmm_tpu_torch import grid

    twin = grid._np_fallback_slowness_planes if twin is None else twin
    veln, velpn, vel_map, stif, tab, has_stif = case
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    host = (np.asarray(veln).astype(npdt), np.asarray(velpn).astype(np.int32),
            np.asarray(vel_map).astype(npdt), np.asarray(stif).astype(npdt),
            np.asarray(tab).astype(npdt))
    want = twin(
        *[a.astype(np.float64) if a.dtype != np.int32 else a for a in host],
        has_stif)
    return host, want


def planes_on_card(host, has_stif, device):
    """K6 on ``host`` (make_model's casts) uploaded to ``device``."""
    from alifmm_tpu_torch.ops import cuda_planes

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host]
    return cuda_planes.fallback_planes(*args, has_stif)


def ulp_gap(got, want):
    """Largest distance in float32 ulps between float32 ``got`` and the
    float64 ``want`` rounded to float32 (both of one sign everywhere)."""
    want32 = np.asarray(want, np.float64).astype(np.float32)
    got = np.asarray(got, np.float32)
    check(bool(np.all(np.signbit(got) == np.signbit(want32))),
          "K6 and its twin differ in sign")
    gi = got.view(np.int32).astype(np.int64)
    wi = want32.view(np.int32).astype(np.int64)
    return int(np.abs(gi - wi).max())


def check_planes(name, dtype, device):
    """K6 on ``PLANES_CASES[name]`` in ``dtype`` against its twin; returns
    the largest float32 ulp gap (float32) or relative error (float64)."""
    *case, has_stif = planes_case(name)
    host, want = planes_inputs((*case, has_stif), dtype)
    got = planes_on_card(host, has_stif, device).cpu().numpy()
    check(got.shape == want.shape, f"K6 {name}: shape {got.shape} against "
          f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"K6 {name}: not finite")
    if dtype == torch.float32:
        gap = ulp_gap(got, want)
        check(gap <= PLANES_MAX_ULP, f"K6 {name} float32: {gap} ulps from "
              f"the float64 twin")
        return dict(max_ulp=gap,
                    off_share=float(np.mean(got != want.astype(np.float32))))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(rel <= PLANES_RTOL_F64, f"K6 {name} float64: {rel:.3e} relative")
    return dict(max_rel=rel)


def check_make_model_planes(dtype, device):
    """make_model on the card: one K6 launch a build, its planes equal to
    K6 on the model's own fields, and every other field bit-equal to a
    model_from_numpy upload of the CPU build's host fields.  Returns the
    build's seconds on the host clock."""
    from alifmm_tpu_torch import grid, weld_data
    from alifmm_tpu_torch.ops import cuda_planes

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    args = (veln, velpn, vel_map, stif, None, None, dnx)
    n0 = cuda_planes.LAUNCHES
    secs, model = time_host(lambda: grid.make_model(*args, dtype=dtype,
                                                    device=device))
    check(cuda_planes.LAUNCHES == n0 + 1, f"make_model ({dtype}): "
          f"{cuda_planes.LAUNCHES - n0} K6 launches, not 1")
    again = cuda_planes.fallback_planes(model.veln, model.velpn, model.vel_map,
                                        model.stif, model.group_tab,
                                        model.has_stif)
    check(torch.equal(model.fallback_slowness, again),
          f"make_model ({dtype}): planes differ from K6 on its fields")
    cpu = grid.make_model(*args, dtype=dtype, device="cpu")
    fields = {name: (None if getattr(cpu, name) is None
                     else getattr(cpu, name).numpy())
              for name in grid.TENSOR_FIELDS}
    ref = grid.model_from_numpy(fields, cpu.has_stif, cpu.phase_info,
                                cpu.group_info, cpu.ray_info, device=device,
                                dtype=dtype, skew_info=cpu.skew_info)
    for name in grid.TENSOR_FIELDS:
        if name == "fallback_slowness":
            continue
        a, b = getattr(model, name), getattr(ref, name)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"make_model ({dtype}): {name} differs from the host upload")
    for name in ("has_stif", "phase_info", "group_info", "ray_info",
                 "skew_info"):
        check(getattr(model, name) == getattr(ref, name),
              f"make_model ({dtype}): {name} differs from the CPU build")
    _, want = planes_inputs((veln, velpn, vel_map, stif,
                             np.asarray(cpu.group_tab.double()), True), dtype)
    got = model.fallback_slowness.cpu().numpy()
    if dtype == torch.float32:
        check(ulp_gap(got, want) <= PLANES_MAX_ULP,
              "make_model float32: planes beyond an ulp of the twin")
    else:
        check(bool(np.all(np.abs(got - want) <= PLANES_RTOL_F64
                          * np.abs(want))),
              "make_model float64: planes beyond the twin's tolerance")
    return secs / 1e3


def planes_bytes(host, has_stif):
    """Bytes K6 must move for ``host``: veln, velpn and vel_map read and
    four planes written at every point, the stiffness row read at the
    points that take the Christoffel solve; and the dense count with every
    stiffness row read."""
    veln, velpn = host[0], host[1]
    n, es = veln.size, veln.itemsize
    base = n * (2 * es + 4 + 4 * es)
    chr_points = int(np.count_nonzero(velpn == 0)) if has_stif else 0
    return base + chr_points * 5 * es, base + (n * 5 * es if has_stif else 0)


def check_make_model_layouts(device):
    """make_model on the card takes inputs in any memory order: the weld's
    maps and tables in Fortran order, and transposed views of them, give
    the model of the C-ordered inputs, field for field."""
    from alifmm_tpu_torch import grid, materials, weld_data

    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    g, p = materials.default_tables()
    want = grid.make_model(veln, velpn, vel_map, stif, g, p, dnx,
                           device=device)
    layouts = dict(
        fortran=[np.asfortranarray(a)
                 for a in (veln, velpn, vel_map, stif, g, p)],
        transposed=[np.ascontiguousarray(np.moveaxis(a, 0, 1)).swapaxes(0, 1)
                    for a in (veln, velpn, vel_map, stif, g, p)])
    for name, args in layouts.items():
        check(not args[0].flags.c_contiguous, f"{name}: veln is C-ordered")
        got = grid.make_model(*args, dnx, device=device)
        for field in grid.TENSOR_FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            check(torch.equal(a, b), f"make_model on {name} inputs: {field} "
                  f"differs from the C-ordered build")
    return list(layouts)


def planes_ops(host, has_stif):
    """Float64 operations K6 computes for ``host``: four wave angles at
    every point, at the Christoffel cost at the stiffness points and the
    table cost elsewhere."""
    veln, velpn = host[0], host[1]
    chr_points = int(np.count_nonzero(velpn == 0)) if has_stif else 0
    return 4 * (chr_points * OPS_PLANES_CHRISTOFFEL
                + (veln.size - chr_points) * OPS_PLANES_TABLE)


def time_planes(host, has_stif, device, n=100):
    """K6 timed warm at ``host``'s shape through its wrapper: CUDA events
    over n launches into one output (the wrapper's checks on the host
    space the launches out, so this is the larger of the two costs), and
    the kernel's mean device time from a profiler trace of n more (None if
    the trace holds no device time)."""
    from alifmm_tpu_torch.ops import cuda_planes

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host]
    out = torch.empty((4, *args[0].shape), dtype=args[0].dtype, device=device)

    def launch():
        cuda_planes.fallback_planes(*args, has_stif, out=out)

    ms = time_events(launch, n)
    prof_us = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "planes_kernel" in ev.key and ev.count:
            total = (getattr(ev, "device_time_total", None)
                     or getattr(ev, "cuda_time_total", 0))
            prof_us = total / ev.count if total else None
    torch.cuda.synchronize()
    return ms, prof_us


def phase_planes(device):
    """K6: against its twin on ``PLANES_CASES`` in float32 and float64,
    make_model on the card (one launch a build, the other fields equal to
    the host upload; inputs in any memory order), then timed at 424 x 500
    in both types beside its bound and the host numpy planes it replaces.
    Returns the kernels line's figures."""
    from alifmm_tpu_torch import grid

    out = dict(cases={})
    for name in PLANES_CASES:
        for dtype in (torch.float32, torch.float64):
            r = check_planes(name, dtype, device)
            out["cases"][f"{name} {str(dtype)[6:]}"] = r
            log(f"  K6 {name} {str(dtype)[6:]}: {r}")
    out["make_model_s"] = {}
    for dtype in (torch.float32, torch.float64):
        secs = check_make_model_planes(dtype, device)
        out["make_model_s"][str(dtype)[6:]] = secs
        log(f"  make_model {str(dtype)[6:]} on the card: one K6 launch, the "
            f"other fields equal to the host upload; {secs:.4f} s")
    layouts = check_make_model_layouts(device)
    log(f"  make_model on {' and '.join(layouts)} inputs equals the "
        f"C-ordered build")
    *case, has_stif = planes_case("weld")
    host32, _ = planes_inputs((*case, has_stif), torch.float32)
    t_np = []
    for _ in range(5):
        t0 = time.perf_counter()
        grid._np_fallback_slowness_planes(*host32, has_stif).astype(np.float32)
        t_np.append(time.perf_counter() - t0)
    out["host_numpy_ms"] = float(np.median(t_np)) * 1e3
    log(f"  the host numpy planes K6 replaces (float32 inputs, as make_model "
        f"ran them): median of 5 {out['host_numpy_ms']:.3f} ms")
    out["timed"] = {}
    for dtype in (torch.float32, torch.float64):
        host, _ = planes_inputs((*case, has_stif), dtype)
        events_ms, prof_us = time_planes(host, has_stif, device)
        dev_ms = prof_us / 1e3 if prof_us else None
        ms = dev_ms or events_ms
        need, dense = planes_bytes(host, has_stif)
        ops = planes_ops(host, has_stif)
        bytes_ms, ops_ms = need / PEAK_BYTES * 1e3, ops / PEAK_FP64 * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        key = str(dtype)[6:]
        out["timed"][key] = dict(
            ms=ms, timed_by="profiler" if dev_ms else "events",
            events_ms=events_ms, profiler_ms=dev_ms, bound_ms=bound_ms,
            bound_by="fp64" if ops_ms > bytes_ms else "bytes",
            bytes_ms=bytes_ms, ops_ms=ops_ms, ops=ops,
            bytes=need, bytes_per_point=need / host[0].size,
            dense_bytes_per_point=dense / host[0].size,
            dense_bound_ms=dense / PEAK_BYTES * 1e3,
            share=bound_ms / ms)
        log(f"  K6 {key} at 424 x 500: "
            f"{prof_us if prof_us is None else round(prof_us, 2)} us a launch "
            f"(profiler), {events_ms * 1e3:.2f} us from launch to launch "
            f"through the wrapper (events over 100); bound "
            f"{bound_ms * 1e3:.2f} us "
            f"({out['timed'][key]['bound_by']}: fp64 {ops / 1e6:.1f} M "
            f"operations {ops_ms * 1e3:.2f} us; bytes "
            f"{need / host[0].size:.1f} B a point {bytes_ms * 1e3:.2f} us, "
            f"dense {dense / host[0].size:.0f} B "
            f"{dense / PEAK_BYTES * 1e6:.2f} us), share {bound_ms / ms:.4f}")
    return out


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


def build_kernels(after_sweep=None):
    """Compile every kernel source, one nvcc per source, all at once;
    ``after_sweep`` is called once ``sweep.cu`` is built, the others
    still compiling.  Returns ptxas' registers and spills by kernel."""
    from alifmm_tpu_torch.ops import cuda_planes, cuda_rays, cuda_sweep

    builds = (cuda_sweep.build, cuda_sweep.build_forms, cuda_rays.build,
              cuda_rays.build_descent, cuda_planes.build)
    t0 = time.perf_counter()

    def timed(build):
        t = time.perf_counter()
        build(verbose=True)
        return time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(timed, b) for b in builds]
        if after_sweep is not None:
            jobs[0].result()
            jobs[1].result()
            after_sweep()
        secs = [job.result() for job in jobs]
    log(f"[2] K1 and K5 (sweep.cu), K1's other forms (sweep_forms.cu), K2 "
        f"and K3 (rays.cu), K4 (descent.cu) and K6 (planes.cu) built "
        f"in {time.perf_counter() - t0:.2f} s, at once (each: "
        + ", ".join(f"{n} {t:.2f} s" for n, t in
                    zip(("sweep.cu", "sweep_forms.cu", "rays.cu",
                         "descent.cu", "planes.cu"), secs)) + ")")
    regs = {}
    for report in (cuda_sweep.BUILD_LOG, cuda_sweep.FORMS_BUILD_LOG,
                   cuda_rays.BUILD_LOG, cuda_rays.DESCENT_BUILD_LOG,
                   cuda_planes.BUILD_LOG):
        regs.update(ptxas_summary(report))
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
        "spill_bytes_f64": max([v[1] for k, v in regs.items()
                                if k.startswith(stem + "<d")] or [0]),
    }
    return entry


def start_k1_twin():
    """Phase 3 in a second process (``--k1-twin``), its output gathered
    by a thread.  Returns (process, lines, thread)."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--k1-twin"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    return proc, lines, reader


def join_k1_twin(job):
    """Wait for phase 3's process and print its log (its times on its own
    clock); fails if it failed.  Returns K1's largest difference."""
    proc, lines, reader = job
    t0 = time.perf_counter()
    rc = proc.wait()
    reader.join()
    log(f"  phase 3's process ended (waited {time.perf_counter() - t0:.1f} "
        f"s for it), exit code {rc}; its log:")
    for ln in lines:
        print(ln, end="", flush=True)
    check(rc == 0, f"phase 3 (K1 against its plain twin) or 14a (its forms) "
          f"failed: exit code {rc}")
    return json.loads(lines[-1])


def stop_k1_twin(job):
    """Kill phase 3's process if it still runs (a check failed first)."""
    if job and job[0].poll() is None:
        job[0].kill()
        job[0].wait()


def main_k1_twin():
    """``python3 chip_smoke.py --k1-twin``: phases 3 and 14a alone, in
    inference mode, with ``sweep.cu`` and ``sweep_forms.cu`` as built by
    the caller; its last line is ``{"max_abs_err": x, "forms": {...}}``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from alifmm_tpu_torch.ops import cuda_sweep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_sweep.build()
    cuda_sweep.build_forms()
    device = torch.device("cuda", 0)
    log("[3] K1 against its plain twin")
    with torch.inference_mode():
        worst = phase_kernel_vs_plain(device)
        log("[14a] K1's other forms against the graphed twin, float64")
        forms = phase_forms_vs_plain(device, (torch.float64,))
    print(json.dumps({"max_abs_err": worst, "forms": forms}), flush=True)
    return 0


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
    job = []
    try:
        regs = build_kernels(after_sweep=lambda: job.extend(start_k1_twin()))
        log("[4] ray kernels (K2, K3) against their plain twins")
        ray_worst = phase_rays_vs_plain(device)
        log("[4b] the ray kernels' fine-path instantiations against their "
            "plain twins: nearest-point tap, exact materials, fast strides")
        merge_worst(ray_worst, phase_fine_rays_vs_plain(device))
        log("[4c] K4 (the descent march) against its plain twin on 48 x 56, "
            "and trace_rays_descent against its composed twin")
        descent_worst = phase_descent_vs_plain(device)
        log("[5b] K1 against its plain twin at the fine path's patch shapes")
        fine_k1_worst = phase_fine_k1_vs_plain(device)
        log("[11a] K1's interpolated table lookup against its twin (qSV "
            "tables)")
        qsv_k1_worst = phase_qsv_kernel(device)
        log("[12a] K5 (the slab sweep) against its twin")
        halo_worst = phase_halo_kernel(device)
        log("[14a] K1's other forms against the graphed twin, float32 "
            "(float64 in the second process)")
        with torch.inference_mode():
            forms_f32 = phase_forms_vs_plain(device, (torch.float32,))
        log("[3] K1 against its plain twin, and [14a] its other forms in "
            "float64, in the second process")
        twin = join_k1_twin(job)
        worst, forms_14a = twin["max_abs_err"], twin["forms"]
        forms_14a["max_abs_err"] = max(forms_14a["max_abs_err"],
                                       forms_f32["max_abs_err"])
        forms_14a["seconds"] = [forms_14a["seconds"], forms_f32["seconds"]]
    finally:
        stop_k1_twin(job)
    log("[5] analytic checks: the isotropic 424 x 500 field with the "
        "default and the accuracy budget; the accuracy preset's cases")
    analytic = phase_analytic(device)
    log("[5c] analytic check on the refined grid (s = 9)")
    analytic_fine = phase_analytic_fine(device)
    log("[6] weld slice (31 fields, 961 rays, float32): direct path, then "
        "through the facade")
    inputs, ttfs, coarse_times, (wall, t_solve, t_rays) = phase_slice(device)
    counts, facade_wall, t_builds = phase_facade(device)
    log(f"  weld slice warm wall clock: facade {facade_wall:.4f} s (its two "
        f"model builds {t_builds:.4f} s, the rest "
        f"{facade_wall - t_builds:.4f} s); direct {wall:.4f} s (solve "
        f"{t_solve:.4f} s, rays {t_rays:.4f} s)")
    log("[7] ray kernels at the weld shape: against their twins, and timed "
        "beside their bounds")
    weld = phase_ray_kernels_weld(inputs, ttfs, ray_worst, device)
    log("[7b] K4 at the weld shape (961 rays, the fields of phase 6): "
        "against its twin, and timed beside its bound")
    k4_weld = phase_descent_weld(inputs, ttfs, descent_worst, device)
    log("[7c] the FMC slice (61 fields, 1891 rays, float32) with each "
        "tracer, direct and through the facade")
    fmc = phase_fmc(device)
    merge_worst(descent_worst, fmc["worst"])
    log("[7d] device profiles (utils/profiling.trace) of a warm weld slice "
        "and a warm FMC slice")
    profiles = phase_profiles(inputs, device)
    log("[8] K1 warm at every stage shape, beside its bound; one plain pass "
        "at the final shape")
    shapes, ms_p, abs_e = phase_pass_timing(inputs)
    final = shapes[-1]
    log("[9] the fine weld slice (s = 9: 31 fields of 3808 x 4492, 961 rays, "
        "float32): direct, with exact materials, through the facade")
    fine = phase_fine_slice(inputs, coarse_times)
    log("[10] K1 at the fine stage shapes, beside its bound, and against "
        "its twin for one source at the final shape; K2 and K3 on the fine "
        "fields, beside their bounds")
    fine_shapes, fine_rays = phase_fine_timing(inputs, fine)
    log("[10b] K4 in grid mode on the fine fields: against its twin, and "
        "timed beside its bound")
    k4_fine = phase_descent_fine(inputs, fine, descent_worst)
    # phase 15a holds the fine halo solve to these fields from the host
    fine["ttfs"] = fine["ttfs"].cpu()
    torch.cuda.empty_cache()
    log("[11b] shear modes: homogeneous qSV 33 x 37, float64, "
        "for_mode('qsv')")
    qsv_homog = phase_qsv_homogeneous(device)
    log("[11c] the qSV weld slice (31 fields, 961 rays, float32, "
        "for_mode('qsv')): direct, then through the facade")
    qsv = phase_qsv_slice(inputs, coarse_times, final["ms"], device)
    c = qsv["counts"]
    log(f"  qSV weld slice: direct {qsv['wall']:.4f} s (solve "
        f"{qsv['solve']:.4f} s, rays {qsv['rays']:.4f} s; stages "
        + ", ".join(f"{n} {t:.4f} s" for n, t in qsv["stages"])
        + f"), final passes {qsv['passes']} converged {qsv['converged']}, "
        f"launches K1 {c['sweep_pass']} K2 {c['march']} K3 "
        f"{c['relax_times']}; facade {qsv['facade_search']['wall']:.4f} s, "
        f"with auto {qsv['facade_auto']['wall']:.4f} s")
    for key in fine_rays:
        merge_worst(ray_worst, fine_rays[key].pop("errs"))
    vs_twin = fine_shapes[-1]["vs_twin"]
    fine_k1_worst = max(fine_k1_worst, vs_twin["float32"]["max_abs"],
                        vs_twin["float64"]["max_abs"])
    fc = fine["counts"]
    log(f"  fine weld slice: direct {fine['wall']:.4f} s (solve "
        f"{fine['solve']:.4f} s, rays {fine['rays']:.4f} s; stages "
        + ", ".join(f"{n} {t:.4f} s" for n, t in fine["stages"])
        + f"), final passes {fine['passes']} converged {fine['converged']}, "
        f"launches K1 {fc['sweep_pass']} K2 {fc['march']} K3 "
        f"{fc['relax_times']}, peak device memory {fine['peak_gb']:.3f} GB; "
        f"facade {fine['facade_wall']:.4f} s; exact-material rays "
        f"{fine['exact_rays']:.4f} s; grid against interp ray times max rel "
        f"{fine['gap_max']:.4e} median {fine['gap_median']:.4e}")

    log("[12b] the sharded solves: solve_halo_sharded with a fixed budget "
        "against K1's solve_fixpoint")
    halo_fixed = phase_halo_fixed(inputs, device)
    log("[12c] solve_ttf_halo at the weld (4 slabs, 2 x 2 blocks), and K5 "
        "timed at the weld's final shape")
    halo_weld = phase_halo_weld(inputs, ttfs, final["ms"], device)
    log("[12d] solve_ttf_sharded and trace_rays_sharded at the weld, "
        "directly and in a one-rank NCCL group")
    sharded = phase_sharded_weld(inputs, device)
    log("[12e] the weld slice through ALI_FMM(grid_mesh=4 virtual z slabs)")
    halo_facade = phase_halo_facade(device)
    log("[13] the tutorial notebook's workload through ALI_FMM (201 x 201, "
        "three transducers, rays at subgrid_size 9, float32): 13a-13e")
    tutorial = phase_tutorial(device, ray_worst)
    tutorial_final = tutorial.pop("final_stage")
    t14 = time.perf_counter()
    log("[14b] the weld slice in each of K1's other forms, then through "
        "ALI_FMM with the FD-free polish")
    forms_weld = phase_forms_weld(inputs, ttfs, coarse_times, device)
    log("[14c] the qSV weld slice with an FD envelope "
        "(for_mode('qsv', phase1_use_ali=False))")
    qsv_ttfs = qsv.pop("ttfs")
    forms_qsv = phase_forms_qsv(inputs, qsv_ttfs, coarse_times, device)
    log("[14d] K1's forms timed beside their bounds and K1's default pass")
    forms_timed = phase_forms_timing(inputs, tutorial_final)
    log(f"  phase 14b-14d: {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    log("[15a] the fine weld (s = 9, 3808 x 4492) through solve_ttf_halo "
        "on four z slabs, against phase 9")
    halo_fine = phase_halo_fine(inputs, fine, fine_shapes[-1]["ms"], device)
    del fine["ttfs"]
    log("[15b] the qSV weld through solve_ttf_halo on four z slabs and on "
        "2 x 2 blocks, against phase 11c")
    halo_qsv = phase_halo_qsv(inputs, qsv_ttfs,
                              (qsv["passes"], qsv["converged"]), device)
    del qsv_ttfs
    log("[15c] the qSH weld slice (for_mode('qsh')): direct, through "
        "ALI_FMM with the auto tracer, and on four z slabs")
    qsh = phase_qsh(inputs, coarse_times, device)
    log("[15d] homogeneous qSH against its closed-form first arrival")
    qsh_homog = phase_qsh_homogeneous(device)
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")
    log("[16] K6 (the model build's fallback planes) against its twin, "
        "through make_model, and timed beside its bound")
    planes = phase_planes(device)

    check("jax" not in sys.modules, "jax was imported")
    kernels = [{
        "name": "K1 sweep pass",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep.cu",
        "replaces": "alifmm_tpu/ops/pallas_sweep.py:124",
        "launches": counts["sweep_pass"],
        "max_abs_err": max(worst, abs_e, fine_k1_worst, qsv_k1_worst,
                           tutorial["k1_max_abs_err"]),
        "ms": final["ms"],
        "plain_ms": ms_p,
        "bound_ms": final["bound_ms"],
        "bound_by": final["bound_by"],
        "library_ms": None,
        "cluster": final["cluster"],
        "lanes": final["lanes"],
        "shapes": shapes + fine_shapes,
        "weld_slice": dict(wall=wall, solve=t_solve, rays=t_rays,
                           facade_wall=facade_wall,
                           facade_model_builds=t_builds),
        "launches_fine_slice": fc["sweep_pass"],
        "fine_slice": {k: fine[k] for k in (
            "wall", "solve", "rays", "passes", "converged", "peak_gb",
            "facade_wall", "exact_rays", "gap_max", "gap_median")},
        "analytic_fine": analytic_fine,
        "analytic": analytic,
        "max_abs_err_table_lookup": qsv_k1_worst,
        "qsv_final_shape": qsv["k1"],
        "launches_qsv_slice": qsv["counts"]["sweep_pass"],
        "qsv_slice": {k: qsv[k] for k in (
            "wall", "solve", "rays", "stages", "passes", "converged",
            "over_qp", "facade_search", "facade_auto")},
        "qsv_homogeneous": qsv_homog,
        "launches_qsh_slice": qsh["counts"]["sweep_pass"],
        "qsh_slice": {k: qsh[k] for k in (
            "wall", "solve", "rays", "stages", "passes", "converged",
            "over_qp", "auto_over_qp", "facade_auto", "halo")},
        "qsh_homogeneous": qsh_homog,
        "launches_tutorial": {k: v["counts"]["sweep_pass"]
                              for k, v in tutorial["calls"].items()},
        "tutorial": tutorial,
    }]
    fd_free = forms_timed["fd_free replace 31x424x500"]
    kernels.append({
        "name": "K1 sweep pass, other forms",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep_forms.cu",
        "replaces": "alifmm_tpu/ops/pallas_sweep.py:124",
        "also_replaces": "alifmm_tpu/ops/sweep.py:322 (gs_pass with "
                         "use_ali=False, use_fd=False or inner > 0)",
        "launches": sum(v for rec in forms_weld.values()
                        for k, v in rec.get("k1", {}).items()
                        if k.startswith("k1_")),
        "max_abs_err": max(forms_14a["max_abs_err"],
                           max(v.get("max_abs_err", 0.0)
                               for v in forms_timed.values())),
        **{k: fd_free[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
        "library_ms": None,
        "timed": "the FD-free replace pass at 31 x 424 x 500",
        "forms_timed": forms_timed,
        "weld_slices": forms_weld,
        "qsv_weld": forms_qsv,
        "fixpoints": forms_14a["fixpoints"],
        "registers": {k: v[0] for k, v in regs.items()
                      if "sweep_forms_kernel" in k},
        "spill_bytes": {k: v[1] for k, v in regs.items()
                        if "sweep_forms_kernel" in k},
    })
    defaults = weld["facade defaults"]
    kernels.append(ray_kernel_entry(
        "K2 ray march", "alifmm_tpu/rays.py:728", counts["march"],
        dict(max_abs_err=ray_worst["march"],
             rays_equal_share=1.0 - ray_worst["march_unequal"],
             launches_fine_slice=fc["march"],
             grid_tap=fine_rays["grid_tap"]["march"],
             grid_tap_exact_materials=fine_rays[
                 "grid_tap_exact_materials"]["march"]),
        weld["march"], defaults["march"], regs, "march_kernel"))
    kernels.append(ray_kernel_entry(
        "K3 relaxation waves and ray times", "alifmm_tpu/rays.py:445",
        counts["relax_times"],
        dict(max_abs_err=ray_worst["relax_vertices"],
             max_abs_err_times=ray_worst["relax_times"],
             max_rel_err_times=ray_worst["relax_times_rel"],
             near_vertical_f32_gap=ray_worst["near_vertical"],
             also_replaces="alifmm_tpu/rays.py:333",
             launches_fine_slice=fc["relax_times"],
             exact_materials=fine_rays["grid_tap_exact_materials"][
                 "relax_times"]),
        weld["relax_times"], defaults["relax_times"], regs,
        "relax_times_kernel"))
    kernels.append({
        "name": "K4 descent march",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/descent.cu",
        "replaces": "alifmm_tpu/rays.py:1121",
        "launches": fmc["tracers"]["descent"]["facade_counts"]["descent"],
        "max_abs_err": descent_worst["descent"],
        "rays_equal_share": 1.0 - descent_worst["descent_unequal"],
        "max_abs_err_relaxed_vertices": descent_worst["relax_vertices"],
        "max_rel_err_times": descent_worst["relax_times_rel"],
        **{k: k4_weld["score_k 0"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "weld": k4_weld,
        "fmc": fmc["k4"],
        "grid_tap": k4_fine,
        "launches_auto": fmc["tracers"]["auto"]["facade_counts"]["descent"],
        "qsv_weld": qsv["k4"],
        "share": k4_weld["score_k 0"]["share"],
        "warps_per_sm": k4_weld["score_k 0"]["warps_per_sm"],
        "registers": {k: v[0] for k, v in regs.items()
                      if k.startswith("descent_kernel<")},
        "spill_bytes_f32": max([v[1] for k, v in regs.items()
                                if k.startswith("descent_kernel<f")] or [0]),
        "spill_bytes_f64": max([v[1] for k, v in regs.items()
                                if k.startswith("descent_kernel<d")] or [0]),
        "fmc_slice": dict(tracers=fmc["tracers"], gaps=fmc["gaps"],
                          flagged=fmc["flagged"]),
        "profiles": profiles,
    })
    s5 = halo_weld["slab_sweep"]
    kernels.append({
        "name": "K5 slab sweep",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/sweep.cu",
        "replaces": "alifmm_tpu/ops/sweep.py:101",
        "also_replaces": "alifmm_tpu/parallel/shard.py:302, :403 (the "
                         "sweeps of _halo_jacobi_block and _halo_block2d)",
        "launches": halo_facade["counts"]["slab_sweep"],
        "max_abs_err": max(halo_worst,
                           halo_weld["refreshed_x_sweep"]["max_abs_err"]),
        **{k: s5[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "timed": "one z-sweep of a slab of the weld's final stage",
        "share": s5["share"],
        "slab_shape": s5["shape"],
        "us_per_line": s5["us_per_line"],
        "k1_us_per_line": s5["k1_us_per_line"],
        "refreshed_x_sweep": halo_weld["refreshed_x_sweep"],
        "us_per_line_launch": halo_weld["us_per_line_launch"],
        "rounds": halo_weld["rounds"],
        "k1_pass_ms": halo_weld["k1_pass_ms"],
        "solve_ttf_halo": halo_weld["solves"],
        "fixed_budget": halo_fixed,
        "launches_fine_halo": halo_fine["k5_launches"],
        "fine_halo": halo_fine,
        "launches_qsv_halo": {k: v["k5_launches"]
                              for k, v in halo_qsv.items()},
        "qsv_halo": halo_qsv,
        "launches_qsh_halo": qsh["halo"]["k5_launches"],
        "sharded": sharded,
        "facade": halo_facade,
        "registers": {k: v[0] for k, v in regs.items()
                      if "slab_sweep_kernel" in k},
    })
    kernels.append(planes_entry(planes, counts["planes"], regs))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def planes_entry(planes, launches, regs):
    """K6's object in the kernels line: the float32 launch at 424 x 500 as
    ``ms``, the rest of ``phase_planes``' figures beside it."""
    t = planes["timed"]["float32"]
    return {
        "name": "K6 fallback planes",
        "route": "cuda",
        "source": "alifmm_tpu_torch/csrc/planes.cu",
        "replaces": "alifmm_tpu_torch/grid.py _np_fallback_slowness_planes "
                    "(host numpy; alifmm_tpu/grid.py's make_model likewise)",
        **planes,
        "launches": launches,
        "max_ulp_f32": max(r["max_ulp"] for r in planes["cases"].values()
                           if "max_ulp" in r),
        "max_rel_err_f64": max(r["max_rel"] for r in planes["cases"].values()
                               if "max_rel" in r),
        **{k: t[k] for k in ("ms", "bound_ms", "bound_by", "share")},
        "plain_ms": planes["host_numpy_ms"],
        "library_ms": None,
        "registers": {k: v[0] for k, v in regs.items()
                      if "planes_kernel" in k},
    }


def main_planes():
    """``python3 chip_smoke.py --planes``: K6 alone (phase 16), in about a
    minute.  Builds ``planes.cu`` (ptxas' report), then holds K6 to its
    twin, checks make_model on the card and times K6; prints the card line
    and K6's object of the kernels line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from alifmm_tpu_torch.ops import cuda_planes

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] device {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_planes.build(verbose=True)
    log(f"[2] K6 (planes.cu) built in {time.perf_counter() - t0:.2f} s")
    regs = ptxas_summary(cuda_planes.BUILD_LOG)
    for name, (n, spill) in regs.items():
        log(f"    ptxas: {name[:120]}: {n} registers, {spill} bytes of "
            f"spill")
    from alifmm_tpu_torch import grid, weld_data

    reset_counts()
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    grid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                    device=device)
    counts = read_counts()
    check(counts["planes"] == 1, f"one make_model on the card launched K6 "
          f"{counts['planes']} times, not once")
    log("[16] K6 against its twin, through make_model, and timed")
    planes = phase_planes(device)
    check("jax" not in sys.modules, "jax was imported")
    print(card, flush=True)
    print(json.dumps(planes_entry(planes, counts["planes"], regs)),
          flush=True)
    return 0


def main_k4():
    """``python3 chip_smoke.py --k4``: K4 alone, in a few minutes.  Builds
    K1 and K4 (ptxas' report for K4), then on the weld's and the FMC's
    fields (solved by K1) and on the slow band, score_k 0 and 5, float32:
    K4 against its twin ray for ray, and timed beside its bound with the
    step split of its profiling build, and with every step exact.  Prints the card
    line and one JSON object of the timings."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from alifmm_tpu_torch import grid, rays, solver, weld_data
    from alifmm_tpu_torch.ops import cuda_rays, cuda_sweep

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] device {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    cuda_sweep.build()
    cuda_rays.build_descent(verbose=True)
    for name, (n, spill) in ptxas_summary(
            cuda_rays.DESCENT_BUILD_LOG).items():
        log(f"    ptxas: {name[:120]}: {n} registers, {spill} bytes of "
            f"spill")
    out = {}

    def timed(args, cross, what):
        ms_twin, want = time_host(lambda: rays.descent_plain(*args))
        descent_vs_twin(args, want, cross, torch.float32, what)
        out[what] = time_descent(args, want, ms_twin)
        # the same launch with every step exact, and each on every 8th
        # ray alone (fewer than one warp an SM sub-partition)
        few = [a[::8].contiguous() for a in args[3:6]]
        for fast in (True, False):
            kw = dict(fast=fast)
            p = cuda_rays.prepare_march_descent(*args, **kw)
            ms = time_events(p.run, 10)
            pf = cuda_rays.prepare_march_descent(*args[:3], *few, args[6],
                                                 **kw)
            us_few = time_events(pf.run, 10) * 1e3 / int(pf.out[4].max())
            prof = descent_profile(args, want, **kw)
            key = f"{'fast' if fast else 'exact'} steps"
            log(f"    {key}: {ms:.4f} ms, every 8th ray alone {us_few:.3f} "
                f"us a step")
            log_profile(prof)
            out[what][key] = dict(ms=ms, us_per_step_few_rays=us_few,
                                  profile=prof)

    for shape, geometry, budgets in (
            ("weld", weld_data.workload(0), SOLVE_KW),
            ("FMC", fmc_geometry(), FMC_SOLVE)):
        veln, velpn, vel_map, stif, sx, sy, pairs, dnx = geometry
        model = grid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                                dtype=torch.float32, device=device)
        scx, scz = weld_data.ray_pairs(sx, sy, pairs, dnx)[:2]
        ttfs = solver.solve_ttf(
            model, torch.as_tensor(scx).float().to(device),
            torch.as_tensor(scz).float().to(device), 1,
            solver.SolveConfig(**budgets))
        for k in (0, 5):
            mat_flat, tidx, src, rec, spec, cross = descent_inputs(
                model, dict(score_k=k), weld_data.SUBGRID, sx, sy, pairs,
                dnx)
            timed((model, mat_flat, ttfs, tidx, src, rec, spec), cross,
                  f"{shape} score_k {k}")
    for case in DESCENT_CASES:
        if case.startswith("slow band"):
            args, _, cross = descent_case(case, torch.float32, device)
            timed(args, cross, case)
    print(card, flush=True)
    print(json.dumps({"k4": out}), flush=True)
    return 0


def main_halo_fine():
    """``python3 chip_smoke.py --halo-fine``: the halo path's cases too long
    for the default run, float32 on the weld's 31 sources (phase 9's
    budgets at s = 9).  Builds K1 and K5 (``sweep.cu``) beside K2 and K3
    (``rays.cu``), solves the fine weld on one device (phase 9's direct
    solve, kept on the host), then (a) the fine weld through
    solve_ttf_halo on 2 x 2 z and x blocks, max abs 0 from one device with
    equal passes and converged, K5 launches in whole rounds, peak device
    memory; (b) ALI_FMM(ttf_mode="grid", grid_mesh=four z slabs)
    .find_all_TTF_rays_parallel(subgrid_size=9), its ray times equal to
    the same facade's without a mesh (phase 9's facade run), each one
    call with every count set to 0 just before it; (c) the qSV weld
    (phase 11c's model, for_mode("qsv")) at s = 9 on one device and on
    four z slabs: max abs 0 between the two with equal passes and
    converged, the seconds of each, and the nearest-point rays through
    the fields with the weld's knobs (recorded under phase 11c's rule,
    not held), beside the one-device qP fine times.  Prints the card line
    and one JSON object of the results."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import warnings

    import alifmm_tpu_torch
    from alifmm_tpu_torch import rays, solver, weld_data
    from alifmm_tpu_torch.ops import cuda_rays, cuda_sweep

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] device {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(b) for b in (cuda_sweep.build,
                                             cuda_rays.build)]:
            job.result()
    log(f"[2] sweep.cu and rays.cu built in {time.perf_counter() - t0:.1f} s")
    alifmm_tpu_torch.tqdm_disable = True
    s = weld_data.SUBGRID
    cfg = solver.SolveConfig(**SOLVE_KW)
    inputs = weld_inputs(device)
    out = {}
    log("[one device] the fine weld, phase 9's direct solve")
    ttfs, info, qp_rays, (t_solve, _, _) = run_fine_slice(inputs)
    want = ttfs.cpu()
    del ttfs
    log(f"  {t_solve:.4f} s, final passes {info.passes} converged "
        f"{info.converged}")
    out["one_device"] = dict(solve=t_solve, passes=info.passes,
                             converged=info.converged)

    log("[a] the fine weld on 2 x 2 blocks")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, hinfo, wall, counts = halo_solve(inputs[0], inputs, "2d", device,
                                          cfg, s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rounds = halo_rounds(counts, "2d", "the fine weld on 2 x 2")
    log(f"  {wall:.4f} s, {rounds} rounds, launches {counts}, peak device "
        f"memory {peak:.3f} GB")
    gap = check_halo_equal(got, hinfo, want, (info.passes, info.converged),
                           "the fine weld on 2 x 2")
    del got
    out["fine_2x2"] = dict(wall=wall, rounds=rounds, passes=hinfo.passes,
                           converged=hinfo.converged, launches=counts,
                           peak_gb=peak, max_abs=gap)

    log("[b] the fine facade with grid_mesh (four z slabs) against the "
        "facade without one")
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    mesh, axis = virtual_mesh(device, "1d")
    tmats = {}
    for key, kw in (("plain", {}),
                    ("mesh", dict(grid_mesh=mesh, grid_axis=axis))):
        fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy,
                                      stif_den=stif, dnx=dnx,
                                      ray_opts=RAY_OPTS, solve_opts=SOLVE_KW,
                                      ttf_mode="grid", **kw)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tmats[key] = fm.find_all_TTF_rays_parallel(
            veln, velpn, vel_map, subgrid_size=s, stif_den=stif,
            trans_pairs=pairs, n_threads=8)
        torch.cuda.synchronize()
        f_wall = time.perf_counter() - t0
        f_counts = read_counts()
        log(f"  facade {key}: {f_wall:.4f} s, launches {f_counts}")
        check_counts(f_counts, f"the fine facade ({key})")
        check((f_counts["slab_sweep"] > 0) == (key == "mesh"),
              f"the fine facade ({key}) launched K5 {f_counts['slab_sweep']} "
              f"times")
        out[f"facade_{key}"] = dict(wall=f_wall, counts=f_counts)
        del fm
        torch.cuda.empty_cache()
    equal = bool(np.array_equal(tmats["mesh"], tmats["plain"]))
    log(f"  ray times with grid_mesh equal to those without: {equal}")
    check(equal, "the fine facade's ray times with grid_mesh differ from "
          "those without")
    out["facade_times_equal"] = equal

    log("[c] the qSV weld at s = 9 on one device and on four z slabs")
    model = qsv_weld_model(torch.float32, device)
    q_inputs = (model,) + tuple(inputs[1:])
    qcfg = solver.SolveConfig.for_mode("qsv")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qttfs, qinfo = solver.solve_ttf(model, q_inputs[1], q_inputs[2], s, qcfg,
                                    return_info=True)
    torch.cuda.synchronize()
    q_solve = time.perf_counter() - t0
    log(f"  one device: {q_solve:.4f} s, final passes {qinfo.passes} "
        f"converged {qinfo.converged}")
    _, _, _, src_xy, rec_xy, tidx = q_inputs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q_rays = rays.trace_rays(model, qttfs, tidx, src_xy, rec_xy, s,
                                 mode="grid", return_reason=True, **RAY_OPTS)
    qwant = qttfs.cpu()
    del qttfs
    search = qsv_search_ends(q_rays, rec_xy, "qSV fine weld, search",
                             edge_rule=False)
    ratio = (q_rays[3].double() / qp_rays[3].double()).cpu()
    log(f"  qSV fine over qP fine ray times: min {float(ratio.min()):.4f} "
        f"median {float(ratio.median()):.4f} max {float(ratio.max()):.4f}")
    torch.cuda.empty_cache()
    got, hinfo, h_wall, counts = halo_solve(model, q_inputs, "1d", device,
                                            qcfg, s)
    rounds = halo_rounds(counts, "1d", "the qSV fine weld on four slabs")
    log(f"  four slabs: {h_wall:.4f} s, {rounds} rounds, launches {counts}")
    gap = check_halo_equal(got, hinfo, qwant, (qinfo.passes,
                                               qinfo.converged),
                           "the qSV fine weld on four slabs")
    del got
    out["qsv_fine"] = dict(
        one_device=dict(solve=q_solve, passes=qinfo.passes,
                        converged=qinfo.converged),
        four_slabs=dict(wall=h_wall, rounds=rounds, passes=hinfo.passes,
                        converged=hinfo.converged, launches=counts,
                        max_abs=gap),
        search=search, over_qp=dict(min=float(ratio.min()),
                                    median=float(ratio.median()),
                                    max=float(ratio.max())))
    print(card, flush=True)
    print(json.dumps({"halo_fine": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit({"--k4": main_k4, "--k1-twin": main_k1_twin,
              "--halo-fine": main_halo_fine, "--planes": main_planes}.get(
        " ".join(sys.argv[1:]), main)())
