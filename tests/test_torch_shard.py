"""PyTorch port, the halo solves: the slab sweep twin (ops/sweep.slab_sweep,
the plain twin of K5) against the JAX package's _sweep_axis with its slab
arguments, and parallel/shard's solve_halo_sharded and solve_ttf_halo
against the port's single-device solves and against the JAX package's
halo solves.  float64; the port on a mesh of four virtual CPU ranks (four
z slabs, or 2 x 2 z and x blocks), JAX on four of the conftest's eight
virtual CPU devices.

Tolerances: the halo solves follow the single-device sweep order point
for point, so with matched budgets (or the same residual-driven stop)
they equal the port's single-device solve bit for bit; against JAX 1e-9
relative (same float64 operations in another framework), 1e-10 for one
sweep; against a differently stopped single-device solve 1e-6, as
tests/test_shard.py holds JAX.  JAX's halo solves run in a second process
while the port runs (tests/_jax_side.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu import solver as jsolver
from alifmm_tpu.ops import sweep as jsweep
from alifmm_tpu.parallel import shard as jshard
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch.ops import sweep as tsweep
from alifmm_tpu_torch.ops.stencils import INF
from alifmm_tpu_torch.parallel import Mesh, shard
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

RTOL_JAX = 1e-9
RTOL_SWEEP = 1e-10
RTOL_STOP = 1e-6
SMALL_STAGES = ((1, 9), (2, 3))
SMALL_SEED = 4
DNX = 1e-3
CPU = torch.device("cpu")


def _to_torch(jm):
    fields = {n: (None if getattr(jm, n) is None else np.asarray(getattr(jm, n)))
              for n in tgrid.TENSOR_FIELDS}
    return tgrid.model_from_numpy(fields, jm.has_stif, jm.phase_info,
                                  jm.group_info, jm.ray_info, device="cpu",
                                  dtype=torch.float64)


def _weldish(Z, X, seed=3):
    """Random orientations on two table speeds (tests/test_api_grid_mesh.py's
    model): both packages' models from the same arrays."""
    rng = np.random.default_rng(seed)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    vel_map = 3000.0 + 500.0 * np.round(rng.uniform(0, 1, (Z, X)))
    jm = jgrid.make_model(veln, np.ones((Z, X), dtype=int), vel_map, None,
                          None, None, DNX, dtype=jnp.float64)
    return jm, _to_torch(jm)


def _isotropic(Z, X):
    jm = jgrid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int),
                          3000.0 * np.ones((Z, X)), None, None, None, DNX,
                          dtype=jnp.float64)
    return jm, _to_torch(jm)


def _qsv(Z, X, mode="qSV"):
    """tests/test_shard.py's rotating-orientation qSV model (``mode="qSH"``:
    the same model with the qSH pair, c66 = 98e9)."""
    c66 = 98e9 if mode == "qSH" else None
    g, p = jmats.generate_mode_curves(263e9, 145e9, 216e9, 129e9, 7800.0,
                                      c66=c66, mode=mode)
    gtab = np.stack([np.arange(361.0), g], axis=1)
    ptab = np.stack([np.arange(361.0), p], axis=1)
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    veln = np.round((30.0 + 60.0 * np.sin(zz / 7.0) * np.cos(xx / 6.0)) % 180)
    jm = jgrid.make_model(veln, np.ones((Z, X), dtype=int), np.ones((Z, X)),
                          None, gtab, ptab, DNX, dtype=jnp.float64)
    return jm, _to_torch(jm)


def _seeds(Z, X, points):
    tt = np.full((len(points), Z, X), INF)
    fixed = np.zeros((len(points), Z, X), bool)
    for b, (z, x) in enumerate(points):
        tt[b, z, x] = 0.0
        fixed[b, z, x] = True
    return tt, fixed


def _meshes(kind):
    """(port mesh, JAX mesh, axis) of four ranks."""
    if kind == "1d":
        return (Mesh([CPU] * 4, ("gz",)),
                JMesh(np.array(jax.devices()[:4]), ("gz",)), "gz")
    arr = np.empty((2, 2), dtype=object)
    arr.fill(CPU)
    return (Mesh(arr, ("gz", "gx")),
            JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("gz", "gx")),
            ("gz", "gx"))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got >= INF * 0.5, want >= INF * 0.5)
    known = want < INF * 0.5
    rel = np.abs(got - want)[known] / np.maximum(np.abs(want[known]), 1e-12)
    assert rel.max() <= rtol, rel.max()


# --------------------------------------------------------------------- #
# one slab sweep against _sweep_axis with offsets
# --------------------------------------------------------------------- #

# A 12 x 20 block of a 30 x 38 grid, placed (global z, global x of its
# local (0, 0)): at the top-left corner (its first two rows and columns
# lie beyond the grid), inside, and at the bottom with the grid's last
# row at local row 7 (rows 8-9 padding, 10-11 the bottom halo).
BLOCK = (12, 20)
GRID = (30, 38)
PLACES = {"top": (-2, -2), "interior": (6, 8), "bottom padded": (22, 14)}


@functools.lru_cache(maxsize=None)
def _block_inputs(place):
    Zb, Xb = BLOCK
    goz, gox = PLACES[place]
    rng = np.random.default_rng(7)
    gz = np.arange(Zb)[:, None] + goz
    gx = np.arange(Xb)[None, :] + gox
    inside = (gz >= 0) & (gz < GRID[0]) & (gx >= 0) & (gx < GRID[1])
    tt = np.empty((2, Zb, Xb))
    for b, (sz, sx) in enumerate(((10, 12), (27, 3))):
        r = np.hypot(gz - sz, gx - sx) * DNX / 3000.0
        tt[b] = r * (1.0 + 0.05 * rng.uniform(size=(Zb, Xb)))
        tt[b][rng.uniform(size=(Zb, Xb)) < 0.4] = INF
    halo = np.zeros((Zb, Xb), bool)
    halo[:2], halo[-2:], halo[:, :2], halo[:, -2:] = True, True, True, True
    tt = np.where(inside, tt, INF)
    fixed = np.broadcast_to(halo | ~inside, tt.shape).copy()
    return tt, fixed


@functools.lru_cache(maxsize=None)
def _block_models():
    return _weldish(*BLOCK, seed=11)


@functools.lru_cache(maxsize=None)
def _jax_sweep(axis):
    jm = _block_models()[0]
    return jax.jit(functools.partial(jsweep._sweep_axis, model=jm, axis=axis))


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("axis", ["z", "x"])
def test_slab_sweep_matches_jax_sweep_axis(axis, place):
    """Each direction, min and replace: the twin's global in-bounds masks
    and edge flags are JAX's."""
    tt, fixed = _block_inputs(place)
    tm = _block_models()[1]
    goz, gox = PLACES[place]
    zg, xg = (goz, GRID[0]), (gox, GRID[1])
    (so, st), (wo, wt) = (zg, xg) if axis == "z" else (xg, zg)
    geom = tsweep.Geometry(so, st, wo, wt)
    fn = _jax_sweep(axis)
    for rev in (False, True):
        for replace in (False, True):
            want = fn(jnp.asarray(tt), fixed=jnp.asarray(fixed),
                      rev=jnp.asarray(rev), replace=jnp.asarray(replace),
                      scan_off=so, scan_total=st, width_off=wo,
                      width_total=wt)
            got, = tsweep.slab_sweep([torch.from_numpy(tt)], [tm],
                                     [torch.from_numpy(fixed)], axis, rev,
                                     replace, [geom])
            _close(got.numpy(), want, RTOL_SWEEP)


def test_slab_refresh_splices_neighbours():
    """The per-line refresh: after a sweep across blocks, each block's halo
    slots hold its neighbours' boundary points of the same line, and INF
    at the grid's edge (what JAX's refresh_carry hands the next line)."""
    tm = _block_models()[1]
    tt, fixed = _block_inputs("interior")
    blocks = [torch.from_numpy(tt) + k for k in range(3)]
    fixeds = [torch.from_numpy(fixed)] * 3
    nb = [(None, 1), (0, 2), (1, None)]
    geoms = [tsweep.Geometry(8, 38, 8 * k - 2, 24) for k in range(3)]
    out = tsweep.slab_sweep(blocks, [tm] * 3, fixeds, "x", False, False,
                            geoms, nb)
    W = BLOCK[0]
    for k, (before, after) in enumerate(nb):
        lo, hi = out[k][..., 0:2, :], out[k][..., W - 2:W, :]
        want_lo = (torch.full_like(lo, INF) if before is None
                   else out[before][..., W - 4:W - 2, :])
        want_hi = (torch.full_like(hi, INF) if after is None
                   else out[after][..., 2:4, :])
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


# --------------------------------------------------------------------- #
# slab_config: K5's layout rule (pure Python; 132 SMs, the H100's)
# --------------------------------------------------------------------- #

SMS = 132
# (B, n_blocks, W, keywords) -> (per_line, blocks a cluster, c, G)
SLAB_LAYOUTS = {
    # the weld's four z slabs (424 / 4 + 4 rows): the refreshed x-sweep's
    # four blocks in one cluster of 4 x 2 CTAs; the slab z-sweeps alone
    "weld 4 slabs x": ((31, 4, 110, {}), (False, 4, 2, 4)),
    "weld 4 slabs z": ((31, 1, 500, dict(refresh=False)), (False, 1, 8, 4)),
    # the weld's 2 x 2 blocks (212 + 4 rows, 250 + 4 columns)
    "weld 2x2 z": ((31, 2, 254, {}), (False, 2, 4, 4)),
    "weld 2x2 x": ((31, 2, 216, {}), (False, 2, 4, 4)),
    # the fine weld (s = 9) on four slabs: 3808 / 4 + 4 rows
    "fine 4 slabs x": ((31, 4, 956, {}), (False, 4, 2, 4)),
    # a few sources: latency-bound, G = 8
    "48x56 4 slabs x": ((3, 4, 16, {}), (False, 4, 2, 8)),
    # more than 8 blocks on one device, blocks on two devices, or forced:
    # the per-line schedule, a cluster a block
    "9 slabs": ((31, 9, 110, {}), (True, 1, 1, 4)),
    "4 slabs on 2 devices": ((31, 4, 110, dict(devices=2)), (True, 1, 2, 4)),
    "forced per line": ((31, 4, 110, dict(per_line=True)), (True, 1, 2, 4)),
    # forced c and G (the checks): ragged tiles in a cluster of 6 CTAs
    "forced c=3": ((3, 2, 32, dict(cluster=3, lanes=4)), (False, 2, 3, 4)),
    # a line of blocks too wide for one cluster's tiles
    "4 slabs 2100 wide": ((8, 4, 2100, {}), (True, 1, 8, 4)),
}


@pytest.mark.parametrize("name", list(SLAB_LAYOUTS))
def test_slab_config_layout(name):
    from alifmm_tpu_torch.ops import cuda_sweep

    (B, n, W, kw), want = SLAB_LAYOUTS[name]
    assert tuple(cuda_sweep.slab_config(B, n, W, SMS, **kw)) == want


@pytest.mark.parametrize("kw", [dict(refresh=False), dict(cluster=8),
                                dict(lanes=2)])
def test_slab_config_rejects(kw):
    """Lines past 8 tiles of MAX_TILE points, a forced cluster past 8
    CTAs' tiles, lanes K5 is not built for."""
    from alifmm_tpu_torch.ops import cuda_sweep

    W = 8 * cuda_sweep.MAX_TILE + 1 if "lanes" not in kw else 110
    with pytest.raises(ValueError):
        cuda_sweep.slab_config(31, 1, W, SMS, **kw)


# --------------------------------------------------------------------- #
# solve_halo_sharded
# --------------------------------------------------------------------- #

FIXED_BUDGET = dict(n_outer=3, n_inner=1, polish=1)
RESIDUAL = dict(n_inner=1, polish=1, rel_tol=3e-3, max_outer=8,
                max_polish=4)
# the weldish model's sources: an interior one and one on slab 0's last row
WELDISH_SOURCES = [(16, 20), (7, 3)]
SHEAR_MODES = ("qSV", "qSH")


def _jax_halo(kind, budget, mode=None):
    """JAX's solve_halo_sharded on the 32 x 40 weldish model's two sources
    (``mode`` "qSV" or "qSH": that shear model's one source, unbatched):
    (field, passes, converged)."""
    if mode:
        jm = _qsv(32, 40, mode)[0]
        tt, fixed = (a[0] for a in _seeds(32, 40, [(16, 20)]))
    else:
        jm = _weldish(32, 40)[0]
        tt, fixed = _seeds(32, 40, WELDISH_SOURCES)
    _, jmesh, axis = _meshes(kind)
    want, info = jshard.solve_halo_sharded(
        jnp.asarray(tt), jm, jnp.asarray(fixed), jmesh, axis=axis,
        return_info=True, **budget)
    return np.asarray(want), int(info.passes), bool(info.converged)


def _jax_ttf(kind):
    """JAX's solve_ttf_halo on ``ttf_world``'s model and sources."""
    jm = _isotropic(*TTF_SHAPE)[0]
    _, jmesh, axis = _meshes(kind)
    jcfg = jsolver.SolveConfig(**CFG, sweep_block=1, patch_block=1)
    want, info = jshard.solve_ttf_halo(jm, TTF_SCX, TTF_SCZ, jmesh,
                                       axis=axis, cfg=jcfg,
                                       stages=SMALL_STAGES,
                                       seed_side=SMALL_SEED,
                                       return_info=True)
    return np.asarray(want), int(info.passes), bool(info.converged)


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX halo solves, in the order the tests take them,
    computed in a second process while the port runs."""
    jobs = {f"fixed {k}": functools.partial(_jax_halo, k, FIXED_BUDGET)
            for k in ("1d", "2d")}
    jobs.update({mode: functools.partial(_jax_halo, "1d", FIXED_BUDGET, mode)
                 for mode in SHEAR_MODES})
    jobs["residual"] = functools.partial(_jax_halo, "1d", RESIDUAL)
    jobs.update({f"ttf {k}": functools.partial(_jax_ttf, k)
                 for k in ("1d", "2d")})
    with _jax_side.references(jobs) as refs:
        yield refs


@pytest.fixture(scope="module")
def weldish():
    """The 32 x 40 random-orientation model, its two sources, and the
    port's single-device solve with the fixed budget."""
    jm, tm = _weldish(32, 40)
    tt, fixed = _seeds(32, 40, WELDISH_SOURCES)
    single, info = tsweep.solve_fixpoint(
        torch.from_numpy(tt), tm, torch.from_numpy(fixed), rel_tol=0.0,
        max_passes=FIXED_BUDGET["n_outer"],
        polish_passes=FIXED_BUDGET["polish"])
    return jm, tm, tt, fixed, single


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_halo_fixed_budget_equals_single_device(jax_refs, weldish, kind):
    """Matched budgets: equal to the port's single-device solve_fixpoint
    (rel_tol 0: every phase-1 pass runs) bit for bit, and to JAX's
    solve_halo_sharded within 1e-9."""
    _, tm, tt, fixed, single = weldish
    mesh, _, axis = _meshes(kind)
    got, info = shard.solve_halo_sharded(
        torch.from_numpy(tt), tm, torch.from_numpy(fixed), mesh, axis=axis,
        return_info=True, **FIXED_BUDGET)
    assert torch.equal(got, single), float((got - single).abs().max())
    want, passes, converged = jax_refs[f"fixed {kind}"].result()
    _close(got.numpy(), want, RTOL_JAX)
    assert info.passes == passes
    assert info.converged == converged


@pytest.mark.parametrize("mode", SHEAR_MODES)
def test_halo_fixed_budget_qsv_anisotropic(jax_refs, mode):
    """The qSV model of tests/test_shard.py (an interpolated table column,
    rotating orientations), and the same model with the qSH pair, on four
    slabs: equal to the single-device solve, within 1e-9 of JAX's halo
    solve."""
    tm = _qsv(32, 40, mode)[1]
    tt, fixed = _seeds(32, 40, [(16, 20)])
    single, _ = tsweep.solve_fixpoint(
        torch.from_numpy(tt), tm, torch.from_numpy(fixed), rel_tol=0.0,
        max_passes=FIXED_BUDGET["n_outer"],
        polish_passes=FIXED_BUDGET["polish"])
    mesh, _, axis = _meshes("1d")
    got = shard.solve_halo_sharded(torch.from_numpy(tt[0]), tm,
                                   torch.from_numpy(fixed[0]), mesh,
                                   axis=axis, **FIXED_BUDGET)
    assert got.shape == (32, 40)
    assert torch.equal(got, single[0])
    _close(got.numpy(), jax_refs[mode].result()[0], RTOL_JAX)


def test_halo_residual_driven_matches(jax_refs, weldish):
    """The residual-driven stop: the same rule as the single-device
    solve_fixpoint with a residual-driven polish, on the same deltas, so
    equal bit for bit with equal SolveInfo; within 1e-9 of JAX's.  (On an
    exactly symmetric isotropic seed the replace passes parted from JAX's
    at tied stencil choices while the twins took PyTorch's CPU square
    root, one ulp off on some inputs; ops/_math.sqrt is correctly rounded
    and tests/test_torch_sweep.py holds that seed.  This test keeps the
    random-orientation model.)"""
    _, tm, tt, fixed, _ = weldish
    mesh, _, axis = _meshes("1d")
    got, info = shard.solve_halo_sharded(
        torch.from_numpy(tt), tm, torch.from_numpy(fixed), mesh, axis=axis,
        return_info=True, **RESIDUAL)
    single, sinfo = tsweep.solve_fixpoint(
        torch.from_numpy(tt), tm, torch.from_numpy(fixed),
        rel_tol=RESIDUAL["rel_tol"], max_passes=RESIDUAL["max_outer"],
        polish_passes=RESIDUAL["polish"],
        max_polish_passes=RESIDUAL["max_polish"])
    assert torch.equal(got, single)
    assert info == sinfo
    want, passes, converged = jax_refs["residual"].result()
    _close(got.numpy(), want, RTOL_JAX)
    assert (info.passes, info.converged) == (passes, converged)


def test_halo_rejects_uneven_split(weldish):
    jm, tm, tt, fixed, _ = weldish
    mesh = Mesh([CPU] * 3, ("gz",))
    with pytest.raises(ValueError):
        shard.solve_halo_sharded(torch.from_numpy(tt), tm,
                                 torch.from_numpy(fixed), mesh)


# --------------------------------------------------------------------- #
# solve_ttf_halo
# --------------------------------------------------------------------- #

# the weld's final gate (3e-3), budgets cut
CFG = dict(patch_max_passes=2, final_max_passes=8, polish_passes=1,
           final_polish_passes=1, final_rel_tol=3e-3, final_max_polish=4)
# 30 x 39: four slabs pad two rows, the 2 x 2 blocks a row pair and a
# column; the second source sits on slab 1's last row, the third near
# the bottom-right corner
TTF_SHAPE = (30, 39)
TTF_SOURCES = [(20.0, 15.0), (5.0, 7.0), (36.0, 28.0)]
TTF_SCX = DNX * np.array([s[0] for s in TTF_SOURCES])
TTF_SCZ = DNX * np.array([s[1] for s in TTF_SOURCES])


@pytest.fixture(scope="module")
def ttf_world():
    """The isotropic 30 x 39 model, its sources and the port's
    single-device staged solve with the same budget."""
    jm, tm = _isotropic(*TTF_SHAPE)
    scx, scz = TTF_SCX, TTF_SCZ
    single, info = tsolver._staged_solve(
        tm, torch.from_numpy(scx), torch.from_numpy(scz), SMALL_STAGES,
        SMALL_SEED, -1.0, tsolver.SolveConfig(**CFG), return_info=True)
    return jm, tm, scx, scz, single, info


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_ttf_halo_pads_and_matches(jax_refs, ttf_world, kind):
    """The telescoped halo solve with rows (and columns) padded to the
    blocks: within 1e-6 of the port's single-device staged solve (equal
    in fact: the same residual-driven stop on the same deltas), within
    1e-9 of JAX's solve_ttf_halo with an equal SolveInfo."""
    _, tm, scx, scz, single, sinfo = ttf_world
    mesh, _, axis = _meshes(kind)
    got, info = shard.solve_ttf_halo(tm, scx, scz, mesh, axis=axis,
                                     cfg=tsolver.SolveConfig(**CFG),
                                     stages=SMALL_STAGES,
                                     seed_side=SMALL_SEED, return_info=True)
    assert got.shape == (3,) + TTF_SHAPE
    _close(got.numpy(), single.numpy(), RTOL_STOP)
    assert torch.equal(got, single) and info == sinfo
    want, passes, converged = jax_refs[f"ttf {kind}"].result()
    _close(got.numpy(), want, RTOL_JAX)
    assert (info.passes, info.converged) == (passes, converged)
