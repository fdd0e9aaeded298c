"""PyTorch port, the slice end to end: model -> telescoped fields -> rays on
a small seeded weld, each package running its own pipeline from the same
numpy inputs (float64).  JAX's pipeline runs in a second process
(tests/_jax_side.py) while the port runs."""

import numpy as np
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import rays as jrays
from alifmm_tpu import solver as jsolver
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch import weld_data
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

RTOL_FIELDS = 1e-9
RTOL_TIMES = 1e-8  # end to end: field ulps feed the march's candidate argmin
SHAPE = (48, 56)
STAGES = ((1, 9), (2, 3))
BUDGET = dict(patch_max_passes=3, final_max_passes=6, polish_passes=2)
RAY_OPTS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                relax_iters=1, relax_quad=3, max_steps=20, cand_stride=7.0)


def _workload():
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(
        seed=2, shape=SHAPE, n_trans=3, gap=15)
    return ((veln, velpn, vel_map, stif, None, None, dnx),
            weld_data.ray_pairs(sx, sy, pairs, dnx))


def _jax_slice():
    """JAX's pipeline: (fields, passes, converged, trace_rays' outputs)."""
    model_args, (scx, scz, src_xy, rec_xy, tidx) = _workload()
    jm = jgrid.make_model(*model_args, dtype=jnp.float64)
    jcfg = jsolver.SolveConfig(**BUDGET, sweep_block=1, patch_block=1)
    jf, jinfo = jsolver._staged_solve(jm, jnp.asarray(scx), jnp.asarray(scz),
                                      STAGES, 4, -1.0, jcfg, return_info=True)
    want = jrays.trace_rays(jm, jf, jnp.asarray(tidx), jnp.asarray(src_xy),
                            jnp.asarray(rec_xy), weld_data.SUBGRID,
                            mode="interp", return_reason=True, **RAY_OPTS)
    return (np.asarray(jf), int(jinfo.passes), bool(jinfo.converged),
            [np.asarray(a) for a in want])


def test_weld_slice_matches_jax():
    model_args, (scx, scz, src_xy, rec_xy, tidx) = _workload()
    S = weld_data.SUBGRID
    with _jax_side.references({"slice": _jax_slice}) as refs:
        tm = tgrid.make_model(*model_args, dtype=torch.float64, device="cpu")
        tf, tinfo = tsolver._staged_solve(tm, torch.from_numpy(scx),
                                          torch.from_numpy(scz), STAGES, 4,
                                          -1.0, tsolver.SolveConfig(**BUDGET),
                                          return_info=True)
        got = trays.trace_rays(tm, tf, torch.from_numpy(tidx),
                               torch.from_numpy(src_xy),
                               torch.from_numpy(rec_xy), S, mode="interp",
                               return_reason=True, **RAY_OPTS)
        jf, passes, converged, want = refs["slice"].result()

    tf = tf.numpy()
    assert np.all(jf < 5e8) and np.all(np.isfinite(tf))
    np.testing.assert_allclose(tf, jf, rtol=RTOL_FIELDS, atol=0)
    assert (tinfo.passes, tinfo.converged) == (passes, converged)
    _, _, wlen, wt, wr = want
    _, _, glen, gt, gr = (a.numpy() for a in got)
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_allclose(gt, wt, rtol=RTOL_TIMES, atol=0)
    assert gt.shape == (9,) and np.all(gt > 0)
