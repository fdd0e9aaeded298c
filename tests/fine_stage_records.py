"""The fine path's final stage, the JAX package against the port, on the CPU
(float64 and float32).  Not a test: a record, run by hand.

``passes``: JAX's ``solve_ttf(subgrid_size=9, return_info=True)`` and the
port's on a 40 x 40 crop of the seeded weld around the bottom receiver at
x = 250 (the crop's bottom edge, as the weld's receivers lie), float64,
with the weld's budgets: the final stage's phase-1 passes, converged flags
and the fields, first at subgrid_size 1 for the model grid's pass count.
Then stage by stage at 9: each package's patch stages, and the JAX
package's final stage from its own 3x patch field and from the port's,
beside the port's final stage from the same field: how far the reference
moves a final field when its input moves by an ulp, and how far the port
is from it on the same input.

``gap``: the state the fine final stage starts from for receiver 22 of the
weld (its 9x and 3x patches solved by JAX in float32, then injected into
the refined grid, 3808 x 4492), one min pass of JAX's ``ops/sweep.gs_pass``
and of the port's plain twin in float32 and in float64 (the float32 state
and materials cast up): each package's float32 against float64 gap, where
it is largest, and the two packages against each other point by point.

Usage:  python tests/fine_stage_records.py passes|gap
(about 20 min for ``passes`` and 20 min for ``gap`` on 8 cores; ``gap``
takes about 12 GB)."""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alifmm_tpu import grid as jgrid  # noqa: E402
from alifmm_tpu import solver as jsolver  # noqa: E402
from alifmm_tpu.ops import sweep as jsweep  # noqa: E402
from alifmm_tpu_torch import grid as tgrid  # noqa: E402
from alifmm_tpu_torch import solver as tsolver  # noqa: E402
from alifmm_tpu_torch import weld_data  # noqa: E402
from alifmm_tpu_torch.ops import sweep as tsweep  # noqa: E402

INF_HALF = 0.5 * float(tsweep.INF)
# the weld workload's budgets (chip_smoke.SOLVE_KW), XLA knobs at 1
BUDGET = dict(final_rel_tol=3e-3, final_polish_passes=2, patch_max_passes=8,
              polish_passes=4)
CROP = (slice(384, 424), slice(230, 270))
SOURCE = (39, 20)            # (z, x) in the crop: the weld's (423, 250)
RECEIVER = 22                # the weld's receiver of the f32/f64 record


def _log(msg):
    print(msg, flush=True)


def _rel(a, b):
    """Largest relative difference where ``b`` is known and not 0."""
    known = (b < INF_HALF) & (b > 0)
    return float((np.abs(a - b)[known] / b[known]).max())


def passes():
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
    args = (veln[CROP], velpn[CROP], vel_map[CROP], stif[CROP], None, None,
            weld_data.DNX)
    jm = jgrid.make_model(*args, dtype=jnp.float64)
    tm = tgrid.make_model(*args, dtype=torch.float64, device="cpu")
    scz, scx = (np.array([c * weld_data.DNX]) for c in SOURCE)
    out = {}
    for s in (1, weld_data.SUBGRID):
        t0 = time.perf_counter()
        jf, jinfo = jsolver.solve_ttf(
            jm, scx, scz, s, jsolver.SolveConfig(sweep_block=1, patch_block=1,
                                                 **BUDGET), return_info=True)
        jf = np.asarray(jf)
        t1 = time.perf_counter()
        tf, tinfo = tsolver.solve_ttf(tm, scx, scz, s,
                                      tsolver.SolveConfig(**BUDGET),
                                      return_info=True)
        tf = tf.numpy()
        t2 = time.perf_counter()
        rec = dict(shape=list(jf.shape[1:]),
                   jax=dict(passes=int(jinfo.passes),
                            converged=bool(jinfo.converged),
                            seconds=t1 - t0),
                   port=dict(passes=int(tinfo.passes),
                             converged=bool(tinfo.converged),
                             seconds=t2 - t1),
                   fields_max_rel=_rel(tf, jf))
        _log(f"subgrid_size {s}: {json.dumps(rec)}")
        out[f"s{s}"] = rec
    out["stages"] = _stages(jm, tm, scx, scz)
    return out


def _points(a, b):
    """(largest relative difference, points over 1e-9) of ``a`` against
    ``b`` where ``b`` is known and not 0."""
    known = (b < INF_HALF) & (b > 0)
    r = np.abs(a - b)[known] / b[known]
    return float(r.max()), int((r > 1e-9).sum())


def _stages(jm, tm, scx, scz):
    s = weld_data.SUBGRID
    jf = jgrid.refine_model(jm, s, dtype=jnp.float64)
    tf = tgrid.refine_model(tm, s)
    jcfg = jsolver.SolveConfig(sweep_block=1, patch_block=1, **BUDGET)
    tcfg = tsolver.SolveConfig(**BUDGET)
    (h0, f0), (h1, f1) = jsolver.fine_stage_params(s)[0]
    side = jsolver.fine_stage_params(s)[1]
    jx, jz = jnp.asarray(scx), jnp.asarray(scz)
    tx, tz = torch.from_numpy(scx), torch.from_numpy(scz)
    j1, jbz, jbx = jsolver._stage_first(jf, jx, jz, h0, f0, side, 1.0, jcfg)
    j2, jbz, jbx = jsolver._stage_next(jf, jx, jz, j1, jbz, jbx, h1, f1,
                                       jcfg)
    t1, bz, bx, _ = tsolver._stage_first(tf, tx, tz, h0, f0, side, 1.0, tcfg)
    t2, bz, bx, _ = tsolver._stage_next(tf, tx, tz, t1, bz, bx, h1, f1, tcfg)
    own, _ = jsolver._stage_final(jf, j2, jbz, jbx, jcfg)
    fed, _ = jsolver._stage_final(jf, jnp.asarray(t2.numpy()), jbz, jbx,
                                  jcfg)
    port, _ = tsolver._stage_final(tf, t2, bz, bx, tcfg)
    own, fed = np.asarray(own), np.asarray(fed)
    rec = dict(patch9=_points(t1.numpy(), np.asarray(j1)),
               patch3=_points(t2.numpy(), np.asarray(j2)),
               jax_final_fed_port_patch3=_points(fed, own),
               port_final_vs_jax_final_same_input=_points(port.numpy(), fed))
    _log(f"stages (max rel, points over 1e-9): {json.dumps(rec)}")
    return rec


def _stage_state():
    """Receiver RECEIVER's injected state at the fine final stage (JAX,
    float32), with the refined float32 model in both packages."""
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(0)
    scx, scz = weld_data.ray_pairs(sx, sy, pairs, dnx)[:2]
    jm = jgrid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                          dtype=jnp.float32)
    fine = jgrid.refine_model(jm, weld_data.SUBGRID, dtype=jnp.float32)
    cfg = jsolver.SolveConfig(sweep_block=1, patch_block=1, **BUDGET)
    stages, side = jsolver.fine_stage_params(weld_data.SUBGRID)
    cx = jnp.asarray(scx[RECEIVER:RECEIVER + 1])
    cz = jnp.asarray(scz[RECEIVER:RECEIVER + 1])
    (h0, f0), (h1, f1) = stages
    tt, bz, bx = jsolver._stage_first(fine, cx, cz, h0, f0, side, 1.0, cfg)
    tt, bz, bx = jsolver._stage_next(fine, cx, cz, tt, bz, bx, h1, f1, cfg)
    Z, X = fine.shape
    tt0, fixed = jsolver._inject(tt[0], (bz[0], bx[0]), 3, (Z, X), (0, 0), 1,
                                 jnp.float32, (Z, X))
    return fine, np.array(tt0), np.array(fixed)


def _torch_fields(jm, dtype):
    fields = {n: (None if getattr(jm, n) is None
                  else np.asarray(getattr(jm, n)))
              for n in tgrid.TENSOR_FIELDS}
    return tgrid.model_from_numpy(fields, jm.has_stif, jm.phase_info,
                                  jm.group_info, jm.ray_info, device="cpu",
                                  dtype=dtype)


def gap():
    t0 = time.perf_counter()
    fine, tt0, fixed = _stage_state()
    _log(f"state {tt0.shape} in {time.perf_counter() - t0:.1f} s")
    Z, X = tt0.shape
    res = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("float64", jnp.float64, torch.float64)):
        jm = jax.tree_util.tree_map(
            lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating)
            else a, fine)
        t0 = time.perf_counter()
        want = np.asarray(jax.jit(jsweep.gs_pass)(
            jnp.asarray(tt0, jdt)[None], jm, jnp.asarray(fixed)[None],
            False))[0]
        t1 = time.perf_counter()
        tm = _torch_fields(jm, tdt)
        del jm
        got = tsweep.gs_pass(torch.from_numpy(tt0).to(tdt)[None], tm,
                             torch.from_numpy(fixed)[None]).numpy()[0]
        t2 = time.perf_counter()
        del tm
        d = np.where((got < INF_HALF) & (want < INF_HALF),
                     np.abs(got.astype(np.float64) - want), 0.0)
        k = int(np.argmax(d))
        res[name] = dict(jax=want, port=got, jax_seconds=t1 - t0,
                         port_seconds=t2 - t1, max_abs=float(d.max()),
                         at=list(divmod(k, X)),
                         equal_share=float((got == want).mean()))
        _log(f"{name}: port against JAX max abs {d.max():.3e} s at (z, x) = "
              f"{divmod(k, X)}, bit-equal share {(got == want).mean():.6f}; "
              f"JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s")
    out = {}
    for pkg in ("jax", "port"):
        a = res["float32"][pkg].astype(np.float64)
        b = res["float64"][pkg]
        d = np.where((a < INF_HALF) & (b < INF_HALF), np.abs(a - b), 0.0)
        k = int(np.argmax(d))
        z, x = divmod(k, X)
        out[pkg] = dict(max_gap=float(d.max()), at=[z, x],
                        float32=float(a[z, x]), float64=float(b[z, x]),
                        largest_time=float(b[b < INF_HALF].max()))
        _log(f"{pkg}: float32 against float64 max {d.max():.4e} s at (z, x) "
             f"= ({z}, {x}): float64 {b[z, x]:.9e}, float32 {a[z, x]:.9e}")
    for name in res:
        for pkg in ("jax", "port"):
            del res[name][pkg]
    return dict(passes={k: v for k, v in res.items()}, gaps=out)


if __name__ == "__main__":
    torch.set_num_threads(4)
    what = sys.argv[1]
    result = {"passes": passes, "gap": gap}[what]()
    print(json.dumps(result))
