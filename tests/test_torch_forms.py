"""PyTorch port, the sweep operator's other forms: the FD-only and the
FD-free local update, the parallel-in-block sweeps, the two-loop
fixpoint (an FD phase-1 envelope, an FD-free polish, parallel phase-1
sweeps), the per-source pass that holds sources of both phases, the
multigrid start of the final stage, gs_pass_unshared, jacobi_pass and
materials.angular_distance_deg, each against the JAX package (float64,
the port's plain twins on the CPU).

The inputs are tests/test_torch_sweep.py's 20 x 26 model (non-square, so
that a reverse sweep's blocks are aligned on the padded 26-line scan)
with its three seeded sources.  JAX's references run in a second process
(tests/_jax_side.py) while the port runs.  Tolerances: the local update
1e-10 relative, a pass 1e-9, fixpoints and staged solves 1e-9 with equal
SolveInfo (the same float64 operations in another framework)."""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import alifmm_tpu_torch
from alifmm_tpu import materials as jmats
from alifmm_tpu import solver as jsolver
from alifmm_tpu.ops import stencils as jst
from alifmm_tpu.ops import sweep as jsweep
from alifmm_tpu_torch import materials as tmats
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.ops import cuda_sweep
from alifmm_tpu_torch.ops import stencils as tst
from alifmm_tpu_torch.ops import sweep as tsweep
from test_torch_sweep import _assert_close, _jax_model, _seeded, _torch_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

RTOL_UPDATE = 1e-10
RTOL_F64 = 1e-9
FLAGS = {"full": (True, True), "fd-only": (False, True),
         "fd-free": (True, False)}
# gs_pass forms: (keyword arguments, replace)
PASS_KW = {"fd-only": dict(use_ali=False), "fd-free": dict(use_fd=False),
           "block fd": dict(block=4, inner=2),
           "block ali": dict(block=4, inner=2, inner_use_ali=True)}
PASS_CASES = {"fd-only min": ("fd-only", False),
              "fd-only replace": ("fd-only", True),
              "fd-free replace": ("fd-free", True),
              "block fd min": ("block fd", False),
              "block fd replace": ("block fd", True),
              "block ali min": ("block ali", False),
              "block ali replace": ("block ali", True)}
FIX_BUDGET = dict(rel_tol=1e-4, max_passes=6, polish_passes=2)
FIXPOINTS = {"fd envelope": dict(phase1_use_ali=False),
             "fd-free polish": dict(polish_use_fd=False,
                                    max_polish_passes=4),
             "parallel phase 1": dict(inner=2, block=4)}
# per source: sources 0 and 1-2 leave phase 1 after 2 and 3 passes
PER_SOURCE = dict(rel_tol=1e-3, max_passes=8, polish_passes=2,
                  max_polish_passes=4, phase1_use_ali=False)
SOLVE_STAGES = ((2, 3),)
SOLVE_SEED = 4
SOLVE_X = np.array([5.0, 18.0]) * 2e-4
SOLVE_Z = np.array([3.0, 14.0]) * 2e-4
SOLVE_BUDGET = dict(rel_tol=1e-3, patch_max_passes=3, polish_passes=2,
                    final_max_passes=4, final_polish_passes=2, sweep_block=1)
SOLVES = {"multigrid": dict(multigrid=True, mg_passes=3, mg_polish=1,
                            patch_block=1),
          "patch_inner, fd-free polish": dict(patch_inner=2, patch_block=2,
                                              final_polish_fd=False)}


def _update_inputs(tt, Z, X, model, lib):
    """local_update's arguments on a padded field, as the sweeps build
    them (usable = known and below the centre)."""
    st = jst if lib is jnp else tst
    pad = (lib.pad(tt, ((0, 0), (2, 2), (2, 2)), constant_values=jst.INF)
           if lib is jnp else torch.nn.functional.pad(tt, (2, 2, 2, 2),
                                                      value=tst.INF))
    nbr, _ = st.neighbors_from_padded(pad, Z, X)
    known = {k: (v < jst.INF * 0.5) & (v < tt) for k, v in nbr.items()}
    fbs = [model.fallback_slowness[f] for f in range(4)]
    return (nbr, known, st.inbounds_masks(Z, X), tt, model.veln,
            model.velpn, model.vel_map, model.stif, fbs, st.edge_masks(Z, X),
            model, model.dnx)


# --------------------------------------------------------------------- #
# JAX references (run in the second process, in this order)
# --------------------------------------------------------------------- #

def _jax_world():
    jm = _jax_model(jnp.float64)
    tt0, fixed = _seeded(jm.shape, np.float64)
    return jm, jnp.asarray(tt0), jnp.asarray(fixed)


def _jax_mid(jm, tt0, fixed):
    """Two default passes from the seeds: a field the replace forms
    change."""
    p = jax.jit(jsweep.gs_pass)
    return p(p(tt0, jm, fixed, False), jm, fixed, False)


def _jax_updates():
    jm, tt0, fixed = _jax_world()
    mid = _jax_mid(jm, tt0, fixed)
    args = _update_inputs(mid, *jm.shape, jm, jnp)
    out = {name: np.asarray(jst.local_update(*args, causal=True, use_ali=a,
                                             use_fd=f))
           for name, (a, f) in FLAGS.items()}
    out["mid"] = np.asarray(mid)
    return out


def _jax_passes():
    jm, tt0, fixed = _jax_world()
    mid = _jax_mid(jm, tt0, fixed)
    out = {}
    for name, kw in PASS_KW.items():
        p = jax.jit(functools.partial(jsweep.gs_pass, **kw))
        for case, (form, rep) in PASS_CASES.items():
            if form == name:
                out[case] = np.asarray(p(mid if rep else tt0, jm, fixed, rep))
    out["unshared"] = np.asarray(jax.jit(jsweep.gs_pass_unshared)(
        tt0, jm, fixed, False))
    out["jacobi"] = np.asarray(jax.jit(jsweep.jacobi_pass)(mid, jm, fixed))
    return out


def _jax_fixpoint(name):
    jm, tt0, fixed = _jax_world()
    want, info = jsweep.solve_fixpoint(tt0, jm, fixed, **FIX_BUDGET,
                                       **FIXPOINTS[name])
    return np.asarray(want), int(info.passes), bool(info.converged)


def _jax_per_source():
    jm, tt0, fixed = _jax_world()

    def one(t, f):
        return jsweep.solve_fixpoint(t, jm, f, **PER_SOURCE)
    want, info = jax.jit(jax.vmap(one))(tt0, fixed)
    return (np.asarray(want), np.asarray(info.passes),
            np.asarray(info.converged))


def _jax_multigrid_final(jm, tt, bz, bx, cfg):
    """JAX's _stage_final with the multigrid start, composed from its own
    functions with the prolongation uncompiled: compiled, XLA contracts
    _prolong3's weighted sums, which moves the start by 2.8e-16 relative,
    and the start's undershoot (the reason JAX warns) flips tied stencil
    choices in the final stage, 7.6e-2 away from the same composition
    run uncompiled.  Returns (field, SolveInfo, warning texts)."""
    Z, X = jm.shape

    def inject_one(ptt, pbz, pbx):
        return jsolver._inject(ptt, (pbz, pbx), 3, (Z, X), (0, 0), 1,
                               jm.vel_map.dtype, (Z, X))

    tt, fixed = jax.vmap(inject_one)(tt, bz, bx)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax.eval_shape(functools.partial(jsolver._stage_final, cfg=cfg), jm,
                       tt, bz, bx)  # traces it: JAX warns at trace time
    tt_c, _ = jsweep.solve_fixpoint(
        tt[:, ::3, ::3], jsolver._decimate_model(jm, 3), fixed[:, ::3, ::3],
        rel_tol=cfg.rel_tol, max_passes=cfg.mg_passes,
        polish_passes=cfg.mg_polish)
    with jax.disable_jit():
        up = jsolver._prolong3(tt_c, Z, X)
    tt = jnp.where(tt < jst.INF * 0.5, tt, up)
    want, info = jsweep.solve_fixpoint(
        tt, jm, fixed, rel_tol=cfg.rel_tol, max_passes=cfg.final_max_passes,
        polish_passes=cfg.final_polish_passes, block=cfg.sweep_block)
    return want, info, [str(w.message) for w in caught]


def _jax_solve(name):
    jm = _jax_model(jnp.float64)
    cfg = jsolver.SolveConfig(**SOLVE_BUDGET, **SOLVES[name])
    scx, scz = jnp.asarray(SOLVE_X), jnp.asarray(SOLVE_Z)
    if not cfg.multigrid:
        want, info = jsolver._staged_solve(jm, scx, scz, SOLVE_STAGES,
                                           SOLVE_SEED, -1.0, cfg,
                                           return_info=True)
        return np.asarray(want), int(info.passes), bool(info.converged), []
    (half, factor), = SOLVE_STAGES
    tt, bz, bx = jsolver._stage_first(jm, scx, scz, half, factor, SOLVE_SEED,
                                      -1.0, cfg)
    want, info, warned = _jax_multigrid_final(jm, tt, bz, bx, cfg)
    return np.asarray(want), int(info.passes), bool(info.converged), warned


@pytest.fixture(scope="module")
def jax_refs():
    jobs = {"updates": _jax_updates, "passes": _jax_passes}
    jobs.update({f"fixpoint {k}": functools.partial(_jax_fixpoint, k)
                 for k in FIXPOINTS})
    jobs["per source"] = _jax_per_source
    jobs.update({f"solve {k}": functools.partial(_jax_solve, k)
                 for k in SOLVES})
    with _jax_side.references(jobs) as refs:
        yield refs


@pytest.fixture(scope="module")
def world():
    jm = _jax_model(jnp.float64)
    tm = _torch_model(jm, torch.float64)
    tt0, fixed = _seeded(jm.shape, np.float64)
    return tm, tt0, fixed


# --------------------------------------------------------------------- #
# the local update and the passes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("flags", list(FLAGS))
def test_local_update_operator_matches_jax(jax_refs, world, flags):
    tm, _, _ = world
    ref = jax_refs["updates"].result()
    mid = torch.from_numpy(ref["mid"])
    use_ali, use_fd = FLAGS[flags]
    got = tst.local_update(*_update_inputs(mid, *tm.shape, tm, torch),
                           causal=True, use_ali=use_ali, use_fd=use_fd)
    want = ref[flags]
    np.testing.assert_array_equal(got.numpy() >= tst.INF * 0.5,
                                  want >= jst.INF * 0.5)
    known = want < jst.INF * 0.5
    np.testing.assert_allclose(got.numpy()[known], want[known],
                               rtol=RTOL_UPDATE)
    # the operators differ where they should
    if flags != "full":
        assert not np.array_equal(want, ref["full"])


def test_local_update_needs_an_operator(world):
    tm, tt0, _ = world
    args = _update_inputs(torch.from_numpy(tt0), *tm.shape, tm, torch)
    for fn in (tst.local_update, jst.local_update):
        with pytest.raises(ValueError, match="at least one of"):
            fn(*args, use_ali=False, use_fd=False)
    with pytest.raises(ValueError, match="at least one of"):
        tsweep.gs_pass(torch.from_numpy(tt0), tm, torch.from_numpy(tt0 < 0),
                       use_ali=False, use_fd=False)


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_gs_pass_form_matches_jax(jax_refs, world, case):
    """One pass of each form, min from the seeds or replace on two default
    passes (JAX's field); the block cases run J = 2 iterations over blocks
    of 4 lines, whose reverse sweeps start with 2 padding lines of the
    26-line scan in the z direction."""
    tm, tt0, fixed = world
    form, rep = PASS_CASES[case]
    ref = jax_refs["passes"].result()
    start = jax_refs["updates"].result()["mid"] if rep else tt0
    got = tsweep.gs_pass(torch.from_numpy(start.copy()), tm,
                         torch.from_numpy(fixed), replace=rep,
                         **PASS_KW[form]).numpy()
    _assert_close(got, ref[case], fixed, RTOL_F64)
    assert np.any(ref[case] != start)


def test_unshared_and_jacobi_passes_match_jax(jax_refs, world):
    tm, tt0, fixed = world
    ref = jax_refs["passes"].result()
    mid = jax_refs["updates"].result()["mid"]
    t = torch.from_numpy
    got = tsweep.gs_pass_unshared(t(tt0), tm, t(fixed), block=4).numpy()
    _assert_close(got, ref["unshared"], fixed, RTOL_F64)
    got = tsweep.jacobi_pass(t(mid), tm, t(fixed)).numpy()
    _assert_close(got, ref["jacobi"], fixed, RTOL_F64)


def test_angular_distance_matches_jax():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(-720, 720, (2, 64))
    got = tmats.angular_distance_deg(a, b)
    np.testing.assert_array_equal(got, jmats.angular_distance_deg(a, b))
    assert float(tmats.angular_distance_deg(350.0, 10.0)) == 20.0
    np.testing.assert_array_equal(tmats._deg2rad(a), jmats._deg2rad(a))


@pytest.mark.parametrize("kw,want", [
    (dict(), tsweep.Form()),
    (dict(block=4), tsweep.Form()),
    (dict(inner=2), tsweep.Form()),
    (dict(block=4, inner=2), tsweep.Form(False, True, 4, 2)),
    (dict(block=2, inner=3, inner_use_ali=True, use_ali=False),
     tsweep.Form(True, True, 2, 3)),
    (dict(use_ali=False), tsweep.Form(False, True)),
    (dict(use_fd=False, block=8), tsweep.Form(True, False))])
def test_pass_form_reads_gs_pass_arguments_as_jax(kw, want):
    """J = inner only with blocks of at least 2 lines, the FD-only inner
    operator unless inner_use_ali; the kernel each form launches."""
    got = tsweep.pass_form(**kw)
    assert got == want
    name = cuda_sweep.form_kernel(got)[0]
    assert name == {(True, True, 0): None, (False, True, 0): "fd_only",
                    (True, False, 0): "fd_free", (False, True, 1): "block_fd",
                    (True, True, 1): "block_full"}[
        (got.use_ali, got.use_fd, int(got.inner > 0))]


# --------------------------------------------------------------------- #
# fixpoints
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(FIXPOINTS))
def test_two_loop_fixpoint_matches_jax(jax_refs, world, name):
    """The two-loop forms through the pass loop the solver calls (the
    plain twin on CPU tensors), with JAX's stop rules."""
    tm, tt0, fixed = world
    t = torch.from_numpy
    got, info = cuda_sweep.solve_fixpoint(t(tt0), tm, t(fixed), **FIX_BUDGET,
                                          **FIXPOINTS[name])
    want, passes, converged = jax_refs[f"fixpoint {name}"].result()
    _assert_close(got.numpy(), want, fixed, RTOL_F64)
    assert (info.passes, info.converged) == (passes, converged)


def test_per_source_pass_holds_both_phases(jax_refs, world):
    """Per-source stop tests with an FD envelope and the ALI polish: the
    sources leave phase 1 at different passes, so a pass runs FD on some
    and ALI on others; JAX vmaps solve_fixpoint over the sources."""
    tm, tt0, fixed = world
    t = torch.from_numpy
    runs = []
    run = tsweep.plain_pass

    def counting(tt, model, fx, rep, act, graphed=False, form=tsweep.DEFAULT):
        runs.append((form, np.flatnonzero(act).tolist()))
        return run(tt, model, fx, rep, act, graphed, form)

    mp = pytest.MonkeyPatch()
    mp.setattr(tsweep, "plain_pass", counting)
    try:
        got, info = cuda_sweep.solve_fixpoint(t(tt0), tm, t(fixed),
                                              per_source=True, **PER_SOURCE)
    finally:
        mp.undo()
    want, passes, converged = jax_refs["per source"].result()
    _assert_close(got.numpy(), want, fixed, RTOL_F64)
    np.testing.assert_array_equal(info.passes, passes)
    np.testing.assert_array_equal(info.converged, converged)
    assert len(set(passes.tolist())) > 1
    fd, ali = tsweep.phase_forms(use_ali=True, phase1_use_ali=False)
    mixed = [i for i in range(len(runs) - 1)
             if runs[i][0] == fd and runs[i + 1][0] == ali
             and not set(runs[i][1]) & set(runs[i + 1][1])]
    assert mixed, runs


# --------------------------------------------------------------------- #
# staged solves and the facade
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(SOLVES))
def test_staged_solve_forms_match_jax(jax_refs, world, name):
    """One 3x patch stage and the final stage: with the multigrid start
    (and JAX's warning, which the port gives too), and with
    parallel-in-block patches and the FD-free final polish.  JAX's
    multigrid stage is held with its prolongation uncompiled
    (``_jax_multigrid_final``)."""
    tm, _, _ = world
    cfg = tsolver.SolveConfig(**SOLVE_BUDGET, **SOLVES[name])
    t = torch.from_numpy
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, info = tsolver._staged_solve(tm, t(SOLVE_X), t(SOLVE_Z),
                                          SOLVE_STAGES, SOLVE_SEED, -1.0,
                                          cfg, return_info=True)
    warned = [str(w.message) for w in caught
              if "multigrid" in str(w.message)]
    want, passes, converged, jax_warned = jax_refs[f"solve {name}"].result()
    assert warned == jax_warned == ([tsolver.MULTIGRID_WARNING]
                                    if cfg.multigrid else [])
    _assert_close(got.numpy(), want, np.zeros(want.shape, bool), RTOL_F64)
    assert (info.passes, info.converged) == (passes, converged)


def test_solve_one_takes_the_operators(world, monkeypatch):
    """solve_one reads use_ali and phase1_use_ali, as the JAX package's
    does, and keeps its strict, FD-fallback, fixed-polish final stage."""
    tm, _, _ = world
    seen = []

    def record(tt, model, fixed, **kw):
        seen.append(kw)
        return tt, tsweep.SolveInfo(0, False)

    monkeypatch.setattr(cuda_sweep, "solve_fixpoint", record)
    cfg = tsolver.SolveConfig(use_ali=False, phase1_use_ali=True,
                              sweep_inner=2, patch_inner=2, multigrid=True,
                              final_polish_fd=False, final_max_polish=9)
    tsolver.solve_one(tm, SOLVE_X[0], SOLVE_Z[0], SOLVE_STAGES, SOLVE_SEED,
                      -1.0, cfg)
    assert len(seen) == 2  # a patch stage and the final stage, no multigrid
    for kw in seen:
        assert (kw["use_ali"], kw["phase1_use_ali"], kw["inner"]) == (
            False, True, 0)
    assert seen[1]["polish_use_fd"] and seen[1]["max_polish_passes"] is None


@pytest.mark.parametrize("opts", [dict(final_polish_fd=False),
                                  tsolver.SolveConfig(multigrid=True)])
def test_facade_passes_the_forms_to_the_solve(opts, monkeypatch):
    """ALI_FMM(solve_opts=...) hands every field to solve_ttf."""
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(
        seed=2, shape=(24, 28), n_trans=2, gap=8)
    stif = np.round(stif).astype(np.int64)
    fm = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy,
                                  stif_den=stif, dnx=dnx, solve_opts=opts,
                                  device="cpu", dtype=torch.float64)
    want = (opts if isinstance(opts, tsolver.SolveConfig)
            else tsolver.SolveConfig(**opts))
    seen = []

    def record(model, scx, scz, s, cfg, progress=None):
        seen.append(cfg)
        return torch.zeros((len(scx),) + model.shape, dtype=model.dtype)

    monkeypatch.setattr(tsolver, "solve_ttf", record)
    monkeypatch.setattr(alifmm_tpu_torch, "tqdm_disable", True)
    fm.update(veln, velpn, vel_map, stif)
    assert seen == [want]
    assert dataclasses.asdict(fm._cfg) == dataclasses.asdict(want)
