"""PyTorch port, solver: the telescoped staged solve against the JAX
package (float64) on the 48 x 56 problem of __graft_entry__, three sources
(two on an edge), small budgets so the per-line CPU twin stays cheap; and
the fine path (subgrid_size = 3) on a crop of it.  JAX's solves of the
first and the last test run in a second process (tests/_jax_side.py),
started with the module's fixture, while the port runs."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from alifmm_tpu import grid as jgrid
from alifmm_tpu import solver as jsolver
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch.ops.stencils import INF
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

RTOL = 1e-9  # same float64 operations: ulps, no tie flips
STAGES = ((1, 9), (2, 3))
SEED_SIDE = 4
BUDGET = dict(patch_max_passes=3, final_max_passes=6, polish_passes=2)
# sweep_block / patch_block only change XLA dispatch; 1 keeps the JAX
# compile small
JCFG = jsolver.SolveConfig(**BUDGET, sweep_block=1, patch_block=1)
TCFG = tsolver.SolveConfig(**BUDGET)


def _jax_problem():
    """The JAX model and the sources: top edge, interior, left edge."""
    jm, dnx, Z, X = graft._small_problem(dtype=np.float64)
    return (jm, dnx * np.array([10.0, 30.0, 0.0]),
            dnx * np.array([0.0, 20.0, 40.0]))


# the fine path's crop of the problem, its two sources (cells) and budget
CROP = (slice(10, 23), slice(14, 25))
CROP_SOURCES = (np.array([3.0, 7.0]), np.array([0.0, 6.0]))
CROP_BUDGET = dict(patch_max_passes=1, polish_passes=0, final_max_passes=2,
                   final_polish_passes=1)
# the first patch stage in parallel-in-block sweeps
INNER = dict(BUDGET, patch_inner=2, patch_block=2)


def _crop_arrays(jm):
    return ([np.asarray(getattr(jm, n))[CROP]
             for n in ("veln", "velpn", "vel_map", "stif")], float(jm.dnx))


def _jax_solves(what):
    """JAX's side of ``test_staged_solve_matches_jax`` ("staged": fields,
    passes, converged), of ``test_patch_stages_per_source_convergence``
    ("stages": the two patch stages) or of ``test_unported_paths_raise``
    ("unported":
    the crop's fine solve with its passes and converged, and the
    parallel-in-block first patch stage)."""
    jm, scx, scz = _jax_problem()
    jx, jz = jnp.asarray(scx), jnp.asarray(scz)
    if what == "staged":
        want, winfo = jsolver._staged_solve(jm, jx, jz, STAGES, SEED_SIDE,
                                            -1.0, JCFG, return_info=True)
        return np.asarray(want), int(winfo.passes), bool(winfo.converged)
    if what == "stages":
        (h0, f0), (h1, f1) = STAGES
        w1, wbz, wbx = jsolver._stage_first(jm, jx, jz, h0, f0, SEED_SIDE,
                                            -1.0, JCFG, use_pallas=False)
        w2, _, _ = jsolver._stage_next(jm, jx, jz, w1, wbz, wbx, h1, f1,
                                       JCFG, use_pallas=False)
        return [np.asarray(a) for a in (w1, wbz, wbx, w2)]
    arrays, dnx = _crop_arrays(jm)
    jcrop = jgrid.make_model(*arrays, None, None, dnx, dtype=jnp.float64)
    x, z = (dnx * c for c in CROP_SOURCES)
    want, winfo = jsolver.solve_ttf(
        jcrop, x, z, 3, jsolver.SolveConfig(**CROP_BUDGET, sweep_block=1,
                                            patch_block=1), return_info=True)
    inner, _, _ = jsolver._stage_first(
        jm, jnp.asarray(scx), jnp.asarray(scz), 1, 9, SEED_SIDE, -1.0,
        jsolver.SolveConfig(**INNER), use_pallas=False)
    return (np.asarray(want), int(winfo.passes), bool(winfo.converged),
            np.asarray(inner))


@pytest.fixture(scope="module")
def problem():
    """(JAX model, port model, scx, scz, JAX's solves in a second
    process)."""
    jobs = {what: functools.partial(_jax_solves, what)
            for what in ("staged", "stages", "unported")}
    with _jax_side.references(jobs) as refs:
        jm, scx, scz = _jax_problem()
        fields = {n: (None if getattr(jm, n) is None
                      else np.asarray(getattr(jm, n)))
                  for n in tgrid.TENSOR_FIELDS}
        tm = tgrid.model_from_numpy(fields, jm.has_stif, jm.phase_info,
                                    jm.group_info, jm.ray_info,
                                    device="cpu", dtype=torch.float64)
        yield jm, tm, scx, scz, refs


def _assert_fields(got, want):
    np.testing.assert_array_equal(got >= INF * 0.5, want >= INF * 0.5)
    known = want < INF * 0.5
    rel = np.abs(got - want)[known] / np.maximum(want[known], 1e-12)
    assert rel.max() < RTOL, rel.max()


def test_staged_solve_matches_jax(problem):
    jm, tm, scx, scz, refs = problem
    names = []
    got, info = tsolver._staged_solve(
        tm, torch.from_numpy(scx), torch.from_numpy(scz), STAGES, SEED_SIDE,
        -1.0, TCFG, return_info=True,
        progress=lambda stage, total, name, seconds: names.append(name))
    want, passes, converged = refs["staged"].result()
    _assert_fields(got.numpy(), want)
    assert got.shape == (3,) + jm.shape
    assert info.passes == passes
    assert info.converged == converged
    assert len(names) == len(STAGES) + 1


def test_patch_stages_per_source_convergence(problem):
    """The patch stages stop per source (the JAX package vmaps them): here
    the sources of stage 2 converge after different pass counts, and every
    source's patch still matches JAX."""
    jm, tm, scx, scz, refs = problem
    tx, tz = torch.from_numpy(scx), torch.from_numpy(scz)
    (h0, f0), (h1, f1) = STAGES
    g1, bz, bx, info1 = tsolver._stage_first(tm, tx, tz, h0, f0, SEED_SIDE,
                                             -1.0, TCFG)
    g2, _, _, info2 = tsolver._stage_next(tm, tx, tz, g1, bz, bx, h1, f1, TCFG)
    w1, wbz, wbx, w2 = refs["stages"].result()
    _assert_fields(g1.numpy(), w1)
    np.testing.assert_array_equal(bz.numpy(), wbz)
    np.testing.assert_array_equal(bx.numpy(), wbx)
    _assert_fields(g2.numpy(), w2)
    assert len(set(info2.passes.tolist())) > 1, info2


def test_unported_paths_raise(problem):
    """solve_ttf(subgrid_size=3), which raised NotImplementedError before
    the fine path was ported, against the JAX package's, with the uncut
    fine schedule (patches of 127 x 127 at 9x and 97 x 97 at 3x, seed sign
    +1) on a 13 x 11 crop of the problem with stiffness and table cells,
    one pass a patch stage; and the first patch stage with the
    parallel-in-block sweeps (patch_inner = 2 over blocks of
    patch_block = 2 lines), which raised NotImplementedError before they
    were ported, against the JAX package's."""
    jm, tm, scx, scz, refs = problem
    arrays, dnx = _crop_arrays(jm)
    tcrop = tgrid.make_model(*arrays, None, None, dnx, dtype=torch.float64,
                             device="cpu")
    x, z = (dnx * c for c in CROP_SOURCES)
    got, info = tsolver.solve_ttf(tcrop, torch.from_numpy(x),
                                  torch.from_numpy(z), 3,
                                  tsolver.SolveConfig(**CROP_BUDGET),
                                  return_info=True)
    got_inner, _, _, _ = tsolver._stage_first(
        tm, torch.from_numpy(scx), torch.from_numpy(scz), 1, 9, SEED_SIDE,
        -1.0, tsolver.SolveConfig(**INNER))
    want, passes, converged, want_inner = refs["unported"].result()
    assert got.shape == (2, 37, 31)
    _assert_fields(got.numpy(), want)
    assert (info.passes, info.converged) == (passes, converged)
    _assert_fields(got_inner.numpy(), want_inner)
