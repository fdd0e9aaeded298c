"""PyTorch port, source sharding, the process group and the facade's grid
mesh: parallel/shard's solve_ttf_sharded and trace_rays_sharded against the
port's unsharded solve and tracer and against the JAX package's sharded
ones, parallel/multihost (the single-process no-op, the hybrid mesh, two
gloo processes), ALI_FMM(grid_mesh=...) against the plain facade and the
JAX facade with its mesh, and utils/progress.stage_reporter.  float64;
the port on meshes of virtual CPU ranks, JAX on the conftest's virtual CPU
devices; a cut 16 x 20 random-orientation model, two small patch stages
and cut budgets.

Tolerances: a sharded solve or trace runs the same operations per source
or ray and the same joint stop as the unsharded one, so it equals it bit
for bit; against JAX 1e-9 relative (same float64 operations in another
framework); the facade with a grid mesh against the plain facade 1e-6
(tests/test_api_grid_mesh.py's bound; equal in fact).  JAX's sharded
solve and facade run in a second process while the port runs
(tests/_jax_side.py)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import alifmm_tpu
import alifmm_tpu_torch
from alifmm_tpu import grid as jgrid
from alifmm_tpu import solver as jsolver
from alifmm_tpu.parallel import shard as jshard
from alifmm_tpu.utils import progress as jprogress
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch.ops.stencils import INF
from alifmm_tpu_torch.parallel import Mesh, multihost, shard
from alifmm_tpu_torch.utils import progress as tprogress
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side
import _torch_gloo_worker as gloo_worker

RTOL_JAX = 1e-9
RTOL_FACADE = 1e-6
STAGES = ((1, 9), (2, 3))
ONE_STAGE = ((2, 3),)
SEED_SIDE = 4
BUDGET = dict(patch_max_passes=2, final_max_passes=3, polish_passes=1)
SHAPE = (16, 20)
DNX = 1e-3
CPU = torch.device("cpu")
RAY_KW = dict(max_steps=30, step_scale=2, relax_iters=1)


def _arrays(Z, X, seed=3):
    rng = np.random.default_rng(seed)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.ones((Z, X), dtype=int)
    vel_map = 3000.0 + 500.0 * np.round(rng.uniform(0, 1, (Z, X)))
    return veln, velpn, vel_map


def _models():
    veln, velpn, vel_map = _arrays(*SHAPE)
    jm = jgrid.make_model(veln, velpn, vel_map, None, None, None, DNX,
                          dtype=jnp.float64)
    fields = {n: (None if getattr(jm, n) is None else np.asarray(getattr(jm, n)))
              for n in tgrid.TENSOR_FIELDS}
    tm = tgrid.model_from_numpy(fields, jm.has_stif, jm.phase_info,
                                jm.group_info, jm.ray_info, device="cpu",
                                dtype=torch.float64)
    return jm, tm


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got >= INF * 0.5, want >= INF * 0.5)
    known = want < INF * 0.5
    if known.any():
        rel = (np.abs(got - want)[known]
               / np.maximum(np.abs(want[known]), 1e-12))
        assert rel.max() <= rtol, rel.max()


def _unsharded(tm, scx, scz):
    return tsolver._staged_solve(tm, torch.from_numpy(scx),
                                 torch.from_numpy(scz), STAGES,
                                 SEED_SIDE, -1.0,
                                 tsolver.SolveConfig(**BUDGET))


# the world's eight sources (two on edges)
WORLD_SCX = DNX * np.array([3.0, 16.0, 11.0, 0.0, 7.0, 19.0, 15.0, 5.0])
WORLD_SCZ = DNX * np.array([2.0, 13.0, 9.0, 12.0, 15.0, 4.0, 0.0, 10.0])
# the facade test's three sources and solve options
FACADE_SCX = DNX * np.array([6.0, 16.0, 13.0])
FACADE_SCZ = DNX * np.array([0.0, 15.0, 10.0])
FACADE_OPTS = dict(BUDGET, final_rel_tol=3e-3, final_max_polish=4)


def _jax_sharded():
    """JAX's solve_ttf_sharded of the world's sources on four devices."""
    jm, _ = _models()
    jmesh = JMesh(np.array(jax.devices()[:4]), ("src",))
    return np.asarray(jshard.solve_ttf_sharded(
        jm, WORLD_SCX, WORLD_SCZ, jmesh,
        cfg=jsolver.SolveConfig(**BUDGET, sweep_block=1, patch_block=1),
        stages=STAGES, seed_side=SEED_SIDE))


def _jax_facade():
    """The JAX facade with four z slabs: ``update`` of the facade test's
    model and sources, with its patch stages cut as the test cuts them."""
    saved = jsolver._COARSE_STAGES, jsolver._COARSE_SEED_SIDE
    jsolver._COARSE_STAGES, jsolver._COARSE_SEED_SIDE = STAGES, SEED_SIDE
    alifmm_tpu.tqdm_disable = True
    try:
        veln, velpn, vel_map = _arrays(*SHAPE)
        jmesh = JMesh(np.array(jax.devices()[:4]), ("gz",))
        return alifmm_tpu.ALI_FMM(
            veln, velpn, vel_map, FACADE_SCX, FACADE_SCZ, dtype=np.float64,
            grid_mesh=jmesh, dnx=DNX,
            solve_opts=dict(FACADE_OPTS, sweep_block=1,
                            patch_block=1)).update(veln, velpn, vel_map)
    finally:
        jsolver._COARSE_STAGES, jsolver._COARSE_SEED_SIDE = saved


def _jax_one_stage():
    """JAX's unsharded staged solve of the world's sources with one 3x
    patch stage (ONE_STAGE)."""
    jm, _ = _models()
    return np.asarray(jsolver._staged_solve(
        jm, jnp.asarray(WORLD_SCX), jnp.asarray(WORLD_SCZ), ONE_STAGE,
        SEED_SIDE, -1.0,
        jsolver.SolveConfig(**BUDGET, sweep_block=1, patch_block=1)))


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX references, computed in a second process while the
    port runs."""
    with _jax_side.references({"sharded": _jax_sharded,
                               "facade": _jax_facade,
                               "one_stage": _jax_one_stage}) as refs:
        yield refs


@pytest.fixture(scope="module")
def world():
    """Both packages' models, the world's eight sources and the port's
    unsharded staged solve of them."""
    jm, tm = _models()
    return (jm, tm, WORLD_SCX, WORLD_SCZ,
            _unsharded(tm, WORLD_SCX, WORLD_SCZ))


def _src_mesh(kind):
    if kind == "4 ranks":
        return Mesh([CPU] * 4, ("src",))
    return multihost.hybrid_mesh(devices=[CPU] * 4, grid_per_host=2)


@pytest.mark.parametrize("kind", ["4 ranks", "hybrid 2 x 2"])
def test_solve_ttf_sharded_matches(jax_refs, world, kind):
    """Eight sources on four source ranks (and on the hybrid (src, gz)
    mesh a multi-process job uses, two source ranks): equal to the
    unsharded solve, the final stage's joint stop included; within 1e-9
    of JAX's."""
    _, tm, scx, scz, single = world
    got = shard.solve_ttf_sharded(tm, scx, scz, _src_mesh(kind),
                                  cfg=tsolver.SolveConfig(**BUDGET),
                                  stages=STAGES, seed_side=SEED_SIDE)
    assert torch.equal(got, single)
    if kind == "4 ranks":
        _close(got.numpy(), jax_refs["sharded"].result(), RTOL_JAX)


def test_solve_ttf_sharded_pads_odd_batch(world):
    """Three sources on two ranks: padded to four with a copy of source 0,
    which moves no joint maximum, and dropped."""
    jm, tm, scx, scz, _ = world
    got = shard.solve_ttf_sharded(tm, scx[:3], scz[:3],
                                  Mesh([CPU] * 2, ("src",)),
                                  cfg=tsolver.SolveConfig(**BUDGET),
                                  stages=STAGES, seed_side=SEED_SIDE)
    assert got.shape == (3,) + SHAPE
    assert torch.equal(got, _unsharded(tm, scx[:3], scz[:3]))


def test_trace_rays_sharded_matches(world):
    """Six rays on four ranks (padded to eight): equal to the unsharded
    tracer ray for ray, within 1e-9 of JAX's sharded tracer."""
    jm, tm, scx, scz, single = world
    s = 3
    src = np.array([[3.0, 2.0], [16.0, 13.0], [3.0, 2.0], [11.0, 9.0],
                    [0.0, 12.0], [19.0, 4.0]]) * s
    rec = np.array([[19.0, 15.0], [0.0, 0.0], [15.0, 15.0], [19.0, 0.0],
                    [12.0, 15.0], [5.0, 15.0]]) * s
    tidx = np.array([0, 1, 0, 2, 3, 5])
    got = shard.trace_rays_sharded(tm, single, tidx, src, rec, s,
                                   _src_mesh("4 ranks"), **RAY_KW)
    want_t = trays.trace_rays(tm, single, tidx, src, rec, s, mode="interp",
                              **RAY_KW)
    for a, b in zip(got, want_t):
        assert torch.equal(a, b)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("src",))
    want_j = jshard.trace_rays_sharded(
        jm, jnp.asarray(single.numpy()), jnp.asarray(tidx), jnp.asarray(src),
        jnp.asarray(rec), s, jmesh, **RAY_KW)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_j[0]),
                               rtol=RTOL_JAX, atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_j[1]),
                               rtol=RTOL_JAX, atol=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_j[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want_j[3]),
                               rtol=RTOL_JAX)


def test_one_stage_schedule_matches_jax(jax_refs, world):
    """The world's sources under a one-stage patch schedule, whose final
    stage starts from a coarse seed that ties stencil choices: source 7
    moved by 2e-1 while the twins' square root was PyTorch's CPU one, one
    ulp off on some inputs; with a correctly rounded root (ops/_math.sqrt)
    within 1e-9 of JAX's."""
    _, tm, scx, scz, _ = world
    got = tsolver._staged_solve(tm, torch.from_numpy(scx),
                                torch.from_numpy(scz), ONE_STAGE, SEED_SIDE,
                                -1.0, tsolver.SolveConfig(**BUDGET))
    _close(got.numpy(), jax_refs["one_stage"].result(), RTOL_JAX)


def test_pad_sources_matches_jax():
    scx, scz = np.arange(5.0), np.arange(5.0) + 1
    for a, b in zip(shard.pad_sources(scx, scz, 4),
                    jshard.pad_sources(scx, scz, 4)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# multihost
# --------------------------------------------------------------------- #

_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")


@pytest.fixture
def fresh_multihost(monkeypatch):
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(multihost, "_init_result", None)
    monkeypatch.setattr(multihost, "_initialized", False)
    return monkeypatch


def test_init_is_single_process_noop(fresh_multihost):
    """No address and no multi-task launch: a no-op, idempotent; a
    one-task SLURM allocation does not count either."""
    assert multihost.init() is False
    assert multihost.init() is False
    assert multihost.is_initialized() is False
    assert "process 0/1" in multihost.process_summary()
    fresh_multihost.setattr(multihost, "_init_result", None)
    fresh_multihost.setenv("SLURM_NTASKS", "1")
    assert multihost.init() is False


def test_init_multitask_launch_needs_an_address(fresh_multihost):
    """A multi-task launch counts: without the coordinator's address it
    raises instead of running alone."""
    fresh_multihost.setenv("OMPI_COMM_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError):
        multihost.init()


def test_hybrid_mesh_defaults_and_split(fresh_multihost):
    mesh = multihost.hybrid_mesh(devices=[CPU] * 8)
    assert mesh.axis_names == ("src", "gz")
    assert mesh.shape == {"src": 8, "gz": 1}
    assert multihost.hybrid_mesh(devices=[CPU] * 8,
                                 grid_per_host=2).shape == {"src": 4, "gz": 2}
    with pytest.raises(ValueError):
        multihost.hybrid_mesh(devices=[CPU] * 8, grid_per_host=3)
    fresh_multihost.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        multihost.hybrid_mesh()


def test_mesh_rejects_mixed_devices():
    with pytest.raises(ValueError):
        Mesh([CPU, torch.device("cuda", 0)], ("gz",))
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("gz", "gx"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_unsharded(tmp_path):
    """solve_ttf_sharded across two gloo processes (each its half of the
    sources, the final stage's delta and scale all-reduced every pass, the
    result all-gathered) equals the unsharded solve in both processes.
    Each process has a join timeout: a hang fails here."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(__file__)),
                    os.path.dirname(__file__)]))
    procs = [subprocess.Popen(
        [sys.executable, gloo_worker.__file__, addr, "2", str(r),
         str(tmp_path / f"rank{r}.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        want = gloo_worker.unsharded().numpy()  # while the processes run
        for p in procs:
            logs.append(p.communicate(timeout=gloo_worker.JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode(errors="replace")[-3000:]
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{r}.npy"),
                                      want)


# --------------------------------------------------------------------- #
# the facade with a grid mesh, and stage_reporter
# --------------------------------------------------------------------- #

def test_facade_grid_mesh_matches(jax_refs, monkeypatch):
    """ALI_FMM(grid_mesh=4 z slabs).update equals the plain facade (within
    1e-6, as JAX is held) and the JAX facade with its mesh within 1e-9."""
    monkeypatch.setattr(tsolver, "_COARSE_STAGES", STAGES)
    monkeypatch.setattr(tsolver, "_COARSE_SEED_SIDE", SEED_SIDE)
    monkeypatch.setattr(alifmm_tpu_torch, "tqdm_disable", True)
    veln, velpn, vel_map = _arrays(*SHAPE)
    kw = dict(dnx=DNX, solve_opts=FACADE_OPTS)
    got = alifmm_tpu_torch.ALI_FMM(
        veln, velpn, vel_map, FACADE_SCX, FACADE_SCZ, dtype=torch.float64,
        device="cpu", grid_mesh=Mesh([CPU] * 4, ("gz",)), **kw).update(
            veln, velpn, vel_map)
    plain = alifmm_tpu_torch.ALI_FMM(
        veln, velpn, vel_map, FACADE_SCX, FACADE_SCZ, dtype=torch.float64,
        device="cpu", **kw).update(veln, velpn, vel_map)
    assert got.shape == plain.shape == (3,) + SHAPE
    _close(got, plain, RTOL_FACADE)
    _close(got, jax_refs["facade"].result(), RTOL_JAX)


class _StubBar:
    def __init__(self):
        self.calls = []

    def set_postfix_str(self, s):
        self.calls.append(("postfix", s))

    def update(self, n=1):
        self.calls.append(("update", n))


def test_stage_reporter_matches_jax():
    """The callback makes the same calls on a bar as the JAX package's."""
    bars = (_StubBar(), _StubBar())
    for mod, bar in zip((jprogress, tprogress), bars):
        cb = mod.stage_reporter(bar)
        cb(stage=1, total=2, name="patch 9x (half=1)", seconds=0.25)
        cb(stage=2, total=2, name="final full-grid", seconds=1.5)
    assert bars[0].calls == bars[1].calls
    assert bars[1].calls[0] == ("postfix", "patch 9x (half=1) 0.25s")
