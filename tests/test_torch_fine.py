"""PyTorch port, the fine-grid path against the JAX package (float64, the
port on the CPU): ``grid.refine_model``, ``solver.fine_stage_params`` and
``solve_ttf(subgrid_size=3)`` (its first patch stage seeded with veln -
angle, where JAX seeds the fine path with veln + angle: JAX's side runs
with the port's sign, ``_jax_side.port_seed_sign``),
``trace_rays(mode="grid")`` on fields of the refined grid,
``exact_materials=True`` (the per-sample Christoffel solve) through every
integrator, ``fast_step_scale`` with its uniform mask, the facade with
``ttf_mode="grid"``, and ``parallel/shard.solve_ttf_halo(subgrid_size=3)``
on four virtual CPU ranks (z slabs) and on 2 x 2 (z and x blocks).

One fine solve serves the module: the fixture solves the receivers of a
13 x 11 weld with stiffness cells at s = 3 once in each package, and the
facades' solves of the same receivers reuse it (the port's through a memo
of ``solve_ttf``, JAX's through its compile cache).  Its schedule is cut
to one patch stage (a 37 x 37 patch at 9x; the fine path's seed side and
sign) in both solver modules: each patch stage costs JAX about 15 s to
trace and compile, and the uncut 127 x 127 patch costs the plain twin 7 s
a pass.  ``tests/test_torch_solver.py`` holds the uncut schedule's solve.
The traces pass the facade's index and coordinate types, so that the
facade's trace reuses a JAX program.  JAX's solves (the fixture's, the
facades' and the halo solves) run in a second process
(tests/_jax_side.py), started with the fixture, while the port runs.

Tolerances: fields and ray times 1e-9 relative (same float64 operations;
sums may reassociate), facade time matrices 1e-8 (field ulps feed the
march's candidate minimum), vertices and paths 1e-9 cells, lengths,
reasons and SolveInfo equal; the halo solves equal to the port's
one-device solve bit for bit (the same sweeps in the same order, the same
stop on the same deltas)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import alifmm_tpu
import alifmm_tpu_torch
from alifmm_tpu import grid as jgrid
from alifmm_tpu import rays as jrays
from alifmm_tpu import solver as jsolver
from alifmm_tpu.parallel import shard as jshard
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.ops import cuda_rays
from alifmm_tpu_torch.parallel import Mesh
from alifmm_tpu_torch.parallel import shard as tshard
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

S = 3
SHAPE = (13, 11)
FINE = ((SHAPE[0] - 1) * S + 1, (SHAPE[1] - 1) * S + 1)
RTOL = 1e-9
RTOL_TIMES = 1e-8
ATOL_CELLS = 1e-9
BUDGET = dict(patch_max_passes=1, polish_passes=0, final_max_passes=2,
              final_polish_passes=1)
TCFG = tsolver.SolveConfig(**BUDGET)
# sweep_block / patch_block change XLA's dispatch only; 1 halves the compile
JBUDGET = dict(BUDGET, sweep_block=1, patch_block=1)
JCFG = jsolver.SolveConfig(**JBUDGET)
# the weld's march knobs at s = 3, with a short step buffer
SIMPSON_KNOBS = dict(max_cross=8, step_scale=3, plane_dist=5, quad_vel=3,
                     relax_iters=1, relax_quad=3, max_steps=40,
                     cand_stride=2.0)
# tests/test_rays_r5.py: the adaptive stride's knobs
FAST_KNOBS = dict(mode="interp", max_steps=80, quad_vel=3, relax_iters=1,
                  relax_quad=3, step_scale=2, fast_step_scale=6)
# the fine schedules as the packages define them (the fixture cuts them)
FINE_PARAMS = (tsolver.fine_stage_params, jsolver.fine_stage_params)
CUT_STAGES = ((2, 9),)
# The halo solves' polish is residual-driven, at most max(final_max_passes,
# 4 x polish) passes, unless final_max_polish is set (in both packages);
# set to the fixed count, it runs the one-device solve's polish.  Four z
# slabs pad the 37 refined rows to 40; 2 x 2 pads a row and a column.
HALO_BUDGET = dict(BUDGET, final_max_polish=BUDGET["final_polish_passes"])
HALO_KINDS = ("1d", "2d")


def _cut(params):
    return lambda s: (CUT_STAGES, params(s)[1])


def _facades(w, ray_opts=None):
    kw = dict(stif_den=w["stif"], dnx=w["dnx"], ray_opts=ray_opts,
              ttf_mode="grid")
    jf = alifmm_tpu.ALI_FMM(w["veln"], w["velpn"], w["vel_map"], w["sx"],
                            w["sy"], dtype=jnp.float64, solve_opts=JBUDGET,
                            **kw)
    tf = alifmm_tpu_torch.ALI_FMM(w["veln"], w["velpn"], w["vel_map"],
                                  w["sx"], w["sy"], dtype=torch.float64,
                                  solve_opts=BUDGET, device="cpu", **kw)
    return jf, tf


def _same_model(a, b):
    return all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(a)))


def _recording(fn, into):
    def rec(*args, **kw):
        out = fn(*args, **kw)
        into.append(out)
        return out
    return rec


def _workload():
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(
        seed=4, shape=SHAPE, n_trans=3, gap=3)
    return dict(veln=veln, velpn=velpn, vel_map=vel_map,
                stif=np.round(stif).astype(np.int64), sx=sx, sy=sy,
                pairs=pairs, dnx=dnx)


def _meshes(kind):
    """(port mesh, JAX mesh, axis) of four ranks: z slabs or 2 x 2."""
    cpu = torch.device("cpu")
    devs = np.array(jax.devices()[:4])
    if kind == "1d":
        return Mesh([cpu] * 4, ("gz",)), JMesh(devs, ("gz",)), "gz"
    arr = np.empty((2, 2), dtype=object)
    arr.fill(cpu)
    return (Mesh(arr, ("gz", "gx")), JMesh(devs.reshape(2, 2), ("gz", "gx")),
            ("gz", "gx"))


# the facades' update mask: the world's receivers
UPDATE_MASK = np.array([0, 0, 0, 1, 1, 1])


def _jax_side_job(what):
    """JAX's side of the module's solves, the schedule cut as the fixture
    cuts it and the fine path seeded with the port's sign
    (``_jax_side.port_seed_sign``), as numpy: "solve" the receivers' solve_ttf(subgrid_size=3)
    (fields, passes, converged, the first patch stage's outputs);
    "facade rays" ALI_FMM(ttf_mode="grid").find_all_TTF_rays (the time
    matrix, ray lengths and paths); "facade update" its ``update`` on
    UPDATE_MASK; "halo 1d"/"halo 2d" solve_ttf_halo(subgrid_size=3) with
    HALO_BUDGET (fields, passes, converged)."""
    w = _workload()
    args = (w["veln"], w["velpn"], w["vel_map"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
        mp.setattr(jsolver, "fine_stage_params", _cut(FINE_PARAMS[1]))
        _jax_side.port_seed_sign(mp)
        if what.startswith("facade"):
            jf = _facades(w, SIMPSON_KNOBS if what == "facade rays"
                          else None)[0]
            if what == "facade update":
                return jf.update(*args, stif_den=w["stif"], subgrid_size=S,
                                 sources=UPDATE_MASK)
            times = jf.find_all_TTF_rays(*args, subgrid_size=S,
                                         trans_pairs=w["pairs"],
                                         stif_den=w["stif"])
            return dict(times=times, ray_len=jf.ray_len, x=jf.ray_paths_x,
                        y=jf.ray_paths_y)
        jm = _facades(w)[0]._make_model(*args, w["stif"])
        scx, scz = weld_data.ray_pairs(w["sx"], w["sy"], w["pairs"],
                                       w["dnx"])[:2]
        if what == "solve":
            first = []
            mp.setattr(jsolver, "_stage_first",
                       _recording(jsolver._stage_first, first))
            want, info = jsolver.solve_ttf(jm, scx, scz, S, JCFG,
                                           return_info=True)
            return (np.asarray(want), int(info.passes), bool(info.converged),
                    [np.asarray(a) for a in first[0]])
        _, jmesh, axis = _meshes(what.split()[1])
        cfg = jsolver.SolveConfig(**HALO_BUDGET, sweep_block=1, patch_block=1)
        want, info = jshard.solve_ttf_halo(jm, scx, scz, jmesh, axis=axis,
                                           subgrid_size=S, cfg=cfg,
                                           return_info=True)
        return np.asarray(want), int(info.passes), bool(info.converged)


@pytest.fixture(scope="module")
def world():
    """The weld, its transducers, both packages' models (built by their
    facades, so that the facades' own builds equal them), the port's fine
    solve of its three receivers with the first patch stage's outputs
    recorded, and JAX's solves (``jax``: ``_jax_side_job``'s, in the order
    the tests take them), computed in a second process meanwhile.  The
    port's later solves of the same model, sources and budget return this
    solve."""
    jobs = {what: functools.partial(_jax_side_job, what)
            for what in ("solve", "facade rays", "facade update")
            + tuple(f"halo {kind}" for kind in HALO_KINDS)}
    with _jax_side.references(jobs) as refs:
        yield from _world(refs)


def _world(refs):
    w = _workload()
    w["jax"] = refs
    veln, velpn, vel_map, pairs, dnx = (w[k] for k in (
        "veln", "velpn", "vel_map", "pairs", "dnx"))
    mp = pytest.MonkeyPatch()
    mp.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
    mp.setattr(alifmm_tpu_torch, "tqdm_disable", True)
    for mod, params in zip((tsolver, jsolver), FINE_PARAMS):
        mp.setattr(mod, "fine_stage_params", _cut(params))
    jf, tf = _facades(w)
    args = (veln, velpn, vel_map, w["stif"])
    jm, tm = jf._make_model(*args), tf._make_model(*args)
    scx, scz = weld_data.ray_pairs(w["sx"], w["sy"], pairs, dnx)[:2]

    tfirst = []
    first = tsolver._stage_first
    mp.setattr(tsolver, "_stage_first", _recording(first, tfirst))
    got, info = tsolver.solve_ttf(tm, torch.from_numpy(scx),
                                  torch.from_numpy(scz), S, TCFG,
                                  return_info=True)
    mp.setattr(tsolver, "_stage_first", first)

    solve = tsolver.solve_ttf
    key = (scx.tobytes(), scz.tobytes(), S, repr(TCFG))

    def memo(model, x, z, subgrid_size=1, cfg=tsolver.SolveConfig(),
             progress=None, return_info=False):
        k = (np.asarray(x).tobytes(), np.asarray(z).tobytes(),
             int(subgrid_size), repr(cfg))
        if k == key and _same_model(model, tm):
            return (got.clone(), info) if return_info else got.clone()
        return solve(model, x, z, subgrid_size, cfg, progress, return_info)

    mp.setattr(tsolver, "solve_ttf", memo)
    w.update(jm=jm, tm=tm, scx=scx, scz=scz, got=got.numpy(), info=info,
             tfirst=[a.numpy() for a in tfirst[0][:3]])
    yield w
    mp.undo()


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _fine_fields(scx, scz, seed):
    """Receiver fields on the refined grid: straight-ray times at 5790 m/s
    with a seeded smooth perturbation."""
    zz, xx = np.meshgrid(np.arange(FINE[0]), np.arange(FINE[1]),
                         indexing="ij")
    rng = np.random.default_rng(seed)
    fields = []
    for cx, cz in zip(scx, scz):
        r = np.hypot(zz - S * cz / weld_data.DNX, xx - S * cx / weld_data.DNX)
        bump = 1.0 + 0.05 * np.sin(zz / 21.0 + rng.uniform(0, 6)) * np.cos(
            xx / 27.0)
        fields.append(weld_data.DNX / S * r * bump / 5790.0)
    return np.stack(fields)


def _trace_both(w, fields, **kw):
    """trace_rays in both packages on the world's rays; returns (want,
    got) as numpy tuples (x, y, lengths, times, reason)."""
    _, _, src_xy, rec_xy, tidx = weld_data.ray_pairs(
        w["sx"], w["sy"], w["pairs"], w["dnx"], S)
    tidx = tidx.astype(np.int32)
    want = jrays.trace_rays(w["jm"], jnp.asarray(fields), jnp.asarray(tidx),
                            jnp.asarray(src_xy), jnp.asarray(rec_xy), S,
                            return_reason=True, **kw)
    got = trays.trace_rays(w["tm"], torch.from_numpy(fields),
                           torch.from_numpy(tidx), torch.from_numpy(src_xy),
                           torch.from_numpy(rec_xy), S, return_reason=True,
                           **kw)
    return (tuple(np.asarray(a) for a in want),
            tuple(a.numpy() for a in got))


def _assert_rays(want, got, what):
    wx, wy, wlen, wt, wr = want
    gx, gy, glen, gt, gr = got
    np.testing.assert_array_equal(glen, wlen, err_msg=what)
    np.testing.assert_array_equal(gr, wr, err_msg=what)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=ATOL_CELLS, err_msg=what)
    np.testing.assert_allclose(gy, wy, rtol=0, atol=ATOL_CELLS, err_msg=what)
    _close(gt, wt, what)
    assert np.all(wr == 0) and wlen.min() > 4 and np.all(wt > 0), what


@pytest.mark.parametrize("scale", [3, 9])
def test_refine_model_matches_jax(world, scale):
    want = jgrid.refine_model(world["jm"], scale, dtype=jnp.float64)
    got = tgrid.refine_model(world["tm"], scale)
    for name in ("veln", "velpn", "vel_map", "stif", "fallback_slowness",
                 "ray_curve_idx"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _close(g, w, name, rtol=1e-12)
    assert got.shape == ((SHAPE[0] - 1) * scale + 1,
                         (SHAPE[1] - 1) * scale + 1)
    assert float(got.dnx) == pytest.approx(want.dnx, rel=1e-15)
    assert got.ray_curves is world["tm"].ray_curves


@pytest.mark.parametrize("s", [3, 5, 9])
def test_fine_stage_params_match_jax(s):
    tparams, jparams = FINE_PARAMS
    assert tparams(s) == jparams(s)
    assert tparams(s)[1] == 4 + 9 * ((s - 1) // 2)


def test_solve_ttf_fine_matches_jax(world):
    """solve_ttf(subgrid_size=3) (the schedule cut as stated above):
    fields on the refined grid, and the final stage's SolveInfo."""
    want, passes, converged, _ = world["jax"]["solve"].result()
    got = world["got"]
    assert got.shape == want.shape == (3,) + FINE
    assert np.all(want < 5e8) and np.all(np.isfinite(got))
    _close(got, want, "fine fields")
    info = world["info"]
    assert (info.passes, info.converged) == (passes, converged)


def test_stage_first_fine_seed_sign(world):
    """The fine path's first stage (a 37 x 37 patch at 9x, analytic seed of
    side 13) seeds with the effective angle veln - angle, as the model grid
    does, where the JAX package (as the reference's travel_finer_grid)
    takes veln + angle, the orientation mirrored: the stage as the port ran
    it inside the solve against JAX's given the port's sign, and the points
    it froze against the port's seed of either sign."""
    (wtt, wbz, wbx), (gtt, gbz, gbx) = (world["jax"]["solve"].result()[3],
                                        world["tfirst"])
    assert gtt.shape == wtt.shape == (3, 37, 37)
    np.testing.assert_array_equal(gbz, wbz)
    np.testing.assert_array_equal(gbx, wbx)
    known = wtt < 5e8
    np.testing.assert_array_equal(gtt < 5e8, known)
    _close(gtt[known], wtt[known], "first patch stage")

    fine = tgrid.refine_model(world["tm"], S)
    isz, isx = tsolver._source_cells(fine, torch.from_numpy(world["scx"]),
                                     torch.from_numpy(world["scz"]))
    ((half, factor),), side = tsolver.fine_stage_params(S)
    hz, hx, bz, bx = tsolver._window(fine, isz, isx, half)
    patches = tsolver._slice_model(fine, bz, bx, hz, hx, factor)
    seeds = {sign: tsolver._analytic_seed(
        patches, fine, isz, isx, (isz - bz) * factor, (isx - bx) * factor,
        side, sign) for sign in (-1.0, 1.0)}
    seed, fixed = (a.numpy() for a in seeds[-1.0])
    assert tsolver._SEED_SIGN == -1.0 and fixed.sum() > 0
    np.testing.assert_array_equal(gtt[fixed], seed[fixed])
    mirrored = seeds[1.0][0].numpy()[fixed]
    assert np.abs(mirrored - seed[fixed]).max() > 1e-3 * seed[fixed].max()


@pytest.mark.parametrize("knobs", [SIMPSON_KNOBS, dict(max_steps=60)],
                         ids=["weld knobs", "walk defaults"])
def test_trace_rays_grid_matches_jax(world, knobs):
    """mode="grid": the nearest fine point of fields on the refined grid.
    The walk scorer's vertices agree with compiled JAX to about 1e-12
    cells here, on fields of seeds 0 to 4 alike."""
    fields = _fine_fields(world["scx"], world["scz"], seed=0)
    want, got = _trace_both(world, fields, mode="grid", **knobs)
    _assert_rays(want, got, f"grid {knobs}")


def _segments(seed, n=64):
    rng = np.random.default_rng(seed)
    Z, X = SHAPE
    pts = [rng.uniform(0, (X - 1) * S, n), rng.uniform(0, (Z - 1) * S, n),
           rng.uniform(0, (X - 1) * S, n), rng.uniform(0, (Z - 1) * S, n)]
    pts[2][:4] = pts[0][:4]  # vertical
    pts[3][4:8] = pts[1][4:8]  # horizontal
    return pts


def _exact_flats(w):
    jmf = jrays._material_flat(w["jm"], exact=True)
    tmf = trays._material_flat(w["tm"], exact=True)
    assert tmf.shape == jmf.shape == (SHAPE[0] * SHAPE[1], 8)
    return jmf, tmf


def test_exact_segment_time_matches_jax(world):
    jmf, tmf = _exact_flats(world)
    pts = _segments(1)
    want = jrays.segment_time(world["jm"], jmf,
                              *(jnp.asarray(p) for p in pts), S, 12)
    got = trays.segment_time(world["tm"], tmf,
                             *(torch.from_numpy(p) for p in pts), S, 12)
    _close(got.numpy(), np.asarray(want), "exact segment_time")
    # the exact rows pick the Christoffel solve in the weld's cells
    fast = trays.segment_time(world["tm"], trays._material_flat(world["tm"]),
                              *(torch.from_numpy(p) for p in pts), S, 12)
    assert not torch.equal(fast, got)


def test_exact_walk_and_simpson_match_jax(world):
    jmf, tmf = _exact_flats(world)
    pts = _segments(2)
    jp = [jnp.asarray(p) for p in pts]
    tp = [torch.from_numpy(p) for p in pts]
    _close(trays._segment_time_walk(world["tm"], tmf, *tp, S, 24).numpy(),
           np.asarray(jrays._segment_time_walk(world["jm"], jmf, *jp, S, 24)),
           "exact walk")
    _close(trays.segment_time_quad3(world["tm"], tmf, *tp, S).numpy(),
           np.asarray(jrays.segment_time_quad3(world["jm"], jmf, *jp, S)),
           "exact simpson3")


def _polylines(w, P, seed):
    _, _, src_xy, rec_xy, _ = weld_data.ray_pairs(w["sx"], w["sy"],
                                                  w["pairs"], w["dnx"], S)
    rng = np.random.default_rng(seed)
    R = src_xy.shape[0]
    lengths = rng.integers(4, P + 1, R)
    x, y = np.zeros((R, P)), np.zeros((R, P))
    for r in range(R):
        n = lengths[r]
        f = np.linspace(0.0, 1.0, n)
        x[r, :n] = src_xy[r, 0] + f * (rec_xy[r, 0] - src_xy[r, 0])
        y[r, :n] = src_xy[r, 1] + f * (rec_xy[r, 1] - src_xy[r, 1])
        x[r, 1:n - 1] += rng.uniform(-2, 2, n - 2)
        y[r, 1:n - 1] += rng.uniform(-2, 2, n - 2)
    return x, y, lengths


@pytest.mark.parametrize("quad", [3, 0], ids=["simpson3", "exact"])
def test_exact_relax_rays_matches_jax(world, quad):
    jmf, tmf = _exact_flats(world)
    x, y, lengths = _polylines(world, 10, seed=quad)
    wx, wy = jrays.relax_rays(world["jm"], jmf, jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(lengths), S,
                              iters=1, max_cross=9, quad=quad, chunk=8)
    gx, gy = trays.relax_rays(world["tm"], tmf, torch.from_numpy(x),
                              torch.from_numpy(y), torch.from_numpy(lengths),
                              S, iters=1, max_cross=9, quad=quad)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=RTOL,
                               atol=ATOL_CELLS)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=RTOL,
                               atol=ATOL_CELLS)
    assert np.any(np.asarray(wx) != x)


def test_exact_ray_times_matches_jax(world):
    jmf, tmf = _exact_flats(world)
    x, y, lengths = _polylines(world, 10, seed=5)
    want = jrays.ray_times(world["jm"], jmf, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(lengths), S, 9, chunk=9)
    got = cuda_rays.ray_times(world["tm"], tmf, torch.from_numpy(x),
                              torch.from_numpy(y),
                              torch.from_numpy(lengths), S, 9)
    _close(got.numpy(), np.asarray(want), "exact ray times")


def test_exact_trace_rays_matches_jax(world):
    """exact_materials=True through the whole trace (march, relaxation,
    ray times), on the refined grid's fields."""
    fields = _fine_fields(world["scx"], world["scz"], seed=0)
    want, got = _trace_both(world, fields, mode="grid", exact_materials=True,
                            **SIMPSON_KNOBS)
    _assert_rays(want, got, "exact materials")


def _fast_case(vel):
    """tests/test_rays_r5.py's geometry on a 28 x 32 isotropic model of
    velocities ``vel``: two rays from the top to receivers near the
    bottom, fields of straight-ray times at 3000 m/s."""
    Z, X, dnx, s = 28, 32, 1e-3, 3
    args = (np.zeros((Z, X)), np.ones((Z, X), dtype=int), vel, None, None,
            None, dnx)
    jm = jgrid.make_model(*args, dtype=jnp.float64)
    tm = tgrid.make_model(*args, dtype=torch.float64, device="cpu")
    rec = [(X - 8.0, Z - 2.0), (6.0, Z - 3.0)]
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    fields = np.stack([dnx * np.hypot(zz - rz, xx - rx) / 3000.0
                       for rx, rz in rec])
    src_xy = np.array([[4.0 * s, 0.0], [(X - 5.0) * s, 0.0]])
    rec_xy = np.array([[rx * s, rz * s] for rx, rz in rec])
    tidx = np.array([0, 1])
    jargs = (jm, jnp.asarray(fields), jnp.asarray(tidx), jnp.asarray(src_xy),
             jnp.asarray(rec_xy), s)
    targs = (tm, torch.from_numpy(fields), torch.from_numpy(tidx),
             torch.from_numpy(src_xy), torch.from_numpy(rec_xy), s)
    return jm, tm, jargs, targs


def _fast_both(jargs, targs, **kw):
    want = jrays.trace_rays(*jargs, return_reason=True, **kw)
    got = trays.trace_rays(*targs, return_reason=True, **kw)
    return (tuple(np.asarray(a) for a in want),
            tuple(a.numpy() for a in got))


def test_uniform_mask_matches_jax(world):
    """The homogeneity mask: on the weld (mostly False), around one slow
    cell (False within the radius only) and on a uniform medium (all
    True)."""
    slow = 3000.0 * np.ones((28, 32))
    slow[14, 16] = 1500.0
    masks = []
    for jm, tm, radius in ((world["jm"], world["tm"], 2),
                           (*_fast_case(slow)[:2], 5),
                           (*_fast_case(3000.0 * np.ones((28, 32)))[:2], 6)):
        want = np.asarray(jrays._uniform_mask(jm, radius))
        got = trays._uniform_mask(tm, radius).numpy()
        np.testing.assert_array_equal(got, want)
        masks.append(got)
    weld, cell, uniform = masks
    assert 0 < weld.mean() < 0.5 and uniform.all()
    assert not cell[14, 16] and not cell[10, 16] and not cell[14, 12]
    assert cell[2, 2] and cell[25, 29]


def test_fast_step_scale_uniform_matches_jax():
    """A uniform medium: the mask is all True, every step far from the
    receiver takes the long stride, and the rays take fewer steps."""
    _, _, jargs, targs = _fast_case(3000.0 * np.ones((28, 32)))
    want, got = _fast_both(jargs, targs, **FAST_KNOBS)
    _assert_rays(want, got, "fast stride, uniform")
    slow_want, _ = _fast_both(jargs, targs, **dict(FAST_KNOBS,
                                                   fast_step_scale=0))
    assert want[2].max() < slow_want[2].max()


def test_fast_step_scale_blocked_matches_jax():
    """A slow band across the model: the mask is False near it, so the
    rays take the long stride only away from it (fewer steps than
    without fast strides, more than on a uniform medium)."""
    vel = 3000.0 * np.ones((28, 32))
    vel[12] = 1500.0
    _, tm, jargs, targs = _fast_case(vel)
    assert 0 < trays._uniform_mask(tm, 10).double().mean() < 1
    want, got = _fast_both(jargs, targs, **FAST_KNOBS)
    _assert_rays(want, got, "fast stride, blocked")
    slow_want, _ = _fast_both(jargs, targs, **dict(FAST_KNOBS,
                                                   fast_step_scale=0))
    _, _, uargs, _ = _fast_case(3000.0 * np.ones((28, 32)))
    uni_want, _ = _fast_both(uargs, targs, **FAST_KNOBS)
    assert uni_want[2].max() < want[2].max() < slow_want[2].max()


def test_facade_grid_mode_rays_match_jax(world):
    """ALI_FMM(ttf_mode="grid").find_all_TTF_rays(subgrid_size=3): the
    receivers' fields on the refined grid, the rays through them."""
    _, tf = _facades(world, SIMPSON_KNOBS)
    kw = dict(subgrid_size=S, trans_pairs=world["pairs"],
              stif_den=world["stif"])
    args = (world["veln"], world["velpn"], world["vel_map"])
    got = tf.find_all_TTF_rays(*args, **kw)
    want = world["jax"]["facade rays"].result()
    np.testing.assert_allclose(got, want["times"], rtol=RTOL_TIMES, atol=0)
    traced = world["pairs"] == 1
    assert np.all(got[traced] > 0) and np.all(got[~traced] == 0)
    np.testing.assert_array_equal(tf.ray_len, want["ray_len"])
    assert np.all(tf.ray_len[traced] > 4)
    for name, key in (("ray_paths_x", "x"), ("ray_paths_y", "y")):
        np.testing.assert_allclose(getattr(tf, name), want[key], rtol=0,
                                   atol=ATOL_CELLS, err_msg=name)


def test_facade_update_fine_matches_jax(world):
    """update(subgrid_size=3) on the receivers: float64 fields on the
    refined grid, zeros for the masked sources."""
    _, tf = _facades(world)
    mask = UPDATE_MASK
    args = (world["veln"], world["velpn"], world["vel_map"])
    got = tf.update(*args, stif_den=world["stif"], subgrid_size=S,
                    sources=mask)
    want = world["jax"]["facade update"].result()
    assert got.dtype == np.float64 and got.shape == (6,) + FINE
    assert np.all(got[mask == 0] == 0)
    _close(got, want, "update fields")
    np.testing.assert_array_equal(got[mask == 1], world["got"])


@pytest.mark.parametrize("kind", HALO_KINDS)
def test_solve_ttf_halo_fine_matches(world, kind):
    """solve_ttf_halo(subgrid_size=3) with the fixture's cut schedule and
    a matched polish budget, the refined grid padded to the blocks (four z
    slabs: 37 rows to 40; 2 x 2: a row and a column): equal to the port's
    one-device solve_ttf with an equal SolveInfo, within 1e-9 of JAX's
    solve_ttf_halo with equal passes and converged."""
    mesh, _, axis = _meshes(kind)
    got, info = tshard.solve_ttf_halo(
        world["tm"], world["scx"], world["scz"], mesh, axis=axis,
        subgrid_size=S, cfg=tsolver.SolveConfig(**HALO_BUDGET),
        return_info=True)
    assert got.shape == (3,) + FINE
    assert torch.equal(got, torch.from_numpy(world["got"]))
    assert info == world["info"]
    want, passes, converged = world["jax"][f"halo {kind}"].result()
    _close(got.numpy(), want, f"halo fields on {kind}")
    assert (info.passes, info.converged) == (passes, converged)
