"""PyTorch port, the facade: alifmm_tpu_torch.ALI_FMM against the JAX
package's ALI_FMM, built from the same numpy arrays (float64, 48 x 56, the
port on the CPU).  Both solvers run a cut stage schedule (9x and 3x
patches around each source) so that a solve takes seconds; everything
else is each facade's own path.  The JAX facade's solving calls run in a
second process (tests/_jax_side.py), started with the module's fixture,
while the port runs.  Tolerances: fields 1e-9 relative (same float64
operations, sums may reassociate), time matrices 1e-8 relative (field
ulps feed the march's candidate minimum), paths 1e-9 model cells, ray
lengths equal."""

import dataclasses
import functools
import inspect
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import alifmm_tpu
import alifmm_tpu_torch
from alifmm_tpu import solver as jsolver
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch import weld_data
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

SHAPE = (48, 56)
STAGES = ((1, 9), (2, 3))
SEED_SIDE = 4
BUDGET = dict(patch_max_passes=3, final_max_passes=6, polish_passes=2,
              sweep_block=1, patch_block=1)
WELD_KNOBS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                  relax_iters=1, relax_quad=3, max_steps=20, cand_stride=7.0)
RTOL_FIELDS = 1e-9
RTOL_TIMES = 1e-8
ATOL_PATHS = 1e-9
# the ray tests' receivers, which the update test selects
MASK = np.array([0, 0, 0, 1, 1, 1])
# the default knobs' four pairs
DEFAULT_PAIRS = np.zeros((6, 6))
DEFAULT_PAIRS[0, 3] = DEFAULT_PAIRS[0, 5] = DEFAULT_PAIRS[2, 4] = 1
DEFAULT_PAIRS[1, 3] = 1


def _arrays():
    veln, velpn, vel_map, stif, sx, sy, pairs, dnx = weld_data.workload(
        seed=2, shape=SHAPE, n_trans=3, gap=15)
    return dict(veln=veln, velpn=velpn, vel_map=vel_map,
                stif=np.round(stif).astype(np.int64), sx=sx, sy=sy,
                pairs=pairs, dnx=dnx)


def _cut_schedule(mp, modules):
    for mod in modules:
        mp.setattr(mod, "_COARSE_STAGES", STAGES)
        mp.setattr(mod, "_COARSE_SEED_SIDE", SEED_SIDE)


def _jax_call(what):
    """The JAX facade's side of a solving test below (``what``: "update",
    "update_i", "rays weld", "rays default"), as numpy: the fields, or the
    time matrix with the ray lengths and paths (and ``ray_path(0, 3)``)."""
    w = _arrays()
    with pytest.MonkeyPatch.context() as mp:
        _cut_schedule(mp, (jsolver,))
        mp.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
        args = _model_args(w)
        if what == "update":
            return _facades(w)[0].update(*args, stif_den=w["stif"],
                                         sources=MASK)
        if what == "update_i":
            return _facades(w)[0].update_i(4, *args, stif_den=w["stif"])
        if what == "rays weld":
            jf = _facades(w, WELD_KNOBS)[0]
            kw = dict(subgrid_size=weld_data.SUBGRID, trans_pairs=w["pairs"])
        else:
            jf = _facades(w)[0]
            kw = dict(subgrid_size=3, trans_pairs=DEFAULT_PAIRS)
        out = dict(times=jf.find_all_TTF_rays(*args, stif_den=w["stif"],
                                              **kw),
                   ray_len=jf.ray_len, x=jf.ray_paths_x, y=jf.ray_paths_y)
        if what == "rays weld":
            out["path"] = jf.ray_path(0, 3)
        return out


@pytest.fixture(scope="module")
def world():
    """Both facades' constructor arguments and the cut stage schedule, and
    the JAX facade's solving calls (``jax``, in the order the tests take
    them).  The port's facades of this module share their solves (see
    ``_shared_solves``)."""
    jobs = {what: functools.partial(_jax_call, what)
            for what in ("update", "update_i", "rays weld", "rays default")}
    with _jax_side.references(jobs) as refs:
        mp = pytest.MonkeyPatch()
        _cut_schedule(mp, (jsolver, tsolver))
        mp.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
        mp.setattr(alifmm_tpu_torch, "tqdm_disable", True)
        mp.setattr(alifmm_tpu_torch.ALI_FMM, "_solve_fields",
                   _shared_solves(alifmm_tpu_torch.ALI_FMM._solve_fields))
        yield dict(_arrays(), jax=refs)
        mp.undo()


def _same_model(a, b):
    return all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(a)))


def _shared_solves(solve):
    """The facade's ``_solve_fields`` run once per model, source set and
    budget: a solve on the CPU takes about 30 s, and the three ray calls
    of this module solve the same three receivers on the same model.  The
    first call of each is held against the JAX facade like any other."""
    done = []

    def shared(self, model, scx, scz, subgrid_size, progress=None):
        key = (np.asarray(scx).tobytes(), np.asarray(scz).tobytes(),
               int(subgrid_size), repr(self._cfg))
        for k, m, fields in done:
            if k == key and _same_model(m, model):
                return fields.clone()
        fields = solve(self, model, scx, scz, subgrid_size, progress)
        done.append((key, model, fields.clone()))
        return fields

    return shared


def _facades(w, ray_opts=None):
    kw = dict(stif_den=w["stif"], dnx=w["dnx"], ray_opts=ray_opts,
              solve_opts=BUDGET)
    jf = alifmm_tpu.ALI_FMM(w["veln"], w["velpn"], w["vel_map"], w["sx"],
                            w["sy"], dtype=jnp.float64, **kw)
    tf = alifmm_tpu_torch.ALI_FMM(w["veln"], w["velpn"], w["vel_map"],
                                  w["sx"], w["sy"], dtype=torch.float64,
                                  device="cpu", **kw)
    return jf, tf


def _model_args(w):
    return (w["veln"], w["velpn"], w["vel_map"])


def test_signatures_match_jax_facade():
    """Every public method of the JAX facade, with the same parameters
    (the constructor adds ``device``)."""
    jcls, tcls = alifmm_tpu.ALI_FMM, alifmm_tpu_torch.ALI_FMM
    names = [n for n, _ in inspect.getmembers(jcls, inspect.isfunction)
             if not n.startswith("_")]
    assert len(names) == 11
    for name in names:
        want = list(inspect.signature(getattr(jcls, name)).parameters)
        got = list(inspect.signature(getattr(tcls, name)).parameters)
        assert got == want, name
    want = list(inspect.signature(jcls.__init__).parameters)
    got = list(inspect.signature(tcls.__init__).parameters)
    assert got == want + ["device"]


def test_attributes_match_jax_facade(world):
    jf, tf = _facades(world)
    for name in ("nnx", "nnz", "nsrc", "maxbt", "dnx", "dnz", "ntr"):
        assert getattr(tf, name) == getattr(jf, name), name
    for name in ("isx", "isz", "nsts", "btg", "ttn", "velocity_dat",
                 "phase_vel"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name))


def test_update_with_sources_mask_matches_jax(world):
    """The mask selects the three receivers of the ray tests below, so
    that the port's facades share one solve (``_shared_solves``) and the
    JAX facades one compiled program of three sources.  A facade whose
    transducers are listed in another order then selects the same three
    with an interleaved mask: each field lands at its source's place."""
    _, tf = _facades(world)
    mask = MASK
    got = tf.update(*_model_args(world), stif_den=world["stif"],
                    sources=mask)
    want = world["jax"]["update"].result()
    assert got.dtype == np.float64 and got.shape == (6,) + SHAPE
    assert np.all(got[mask == 0] == 0) and np.all(got[mask == 1].max((1, 2)) > 0)
    np.testing.assert_allclose(got, want, rtol=RTOL_FIELDS, atol=0)

    order = np.array([3, 0, 4, 1, 2, 5])
    _, tf2 = _facades(dict(world, sx=world["sx"][order],
                           sy=world["sy"][order]))
    mask2 = np.array([1, 0, 1, 0, 0, 1])
    got2 = tf2.update(*_model_args(world), stif_den=world["stif"],
                      sources=mask2)
    np.testing.assert_array_equal(got2, got[order] * mask2[:, None, None])


def test_update_i_matches_jax(world):
    _, tf = _facades(world)
    got = tf.update_i(4, *_model_args(world), stif_den=world["stif"])
    want = world["jax"]["update_i"].result()
    assert got.dtype == np.float64 and got.shape == SHAPE
    np.testing.assert_allclose(got, want, rtol=RTOL_FIELDS, atol=0)


def _compare_rays(want, tf, got, pairs):
    """The port's facade ``tf`` and its time matrix ``got`` against the
    JAX facade's results ``want`` (``_jax_call``)."""
    np.testing.assert_allclose(got, want["times"], rtol=RTOL_TIMES, atol=0)
    traced = pairs == 1
    assert np.all(got[traced] > 0) and np.all(got[~traced] == 0)
    np.testing.assert_array_equal(tf.ray_len, want["ray_len"])
    assert np.all(tf.ray_len[traced] > 2)
    np.testing.assert_allclose(tf.ray_paths_x, want["x"], rtol=0,
                               atol=ATOL_PATHS)
    np.testing.assert_allclose(tf.ray_paths_y, want["y"], rtol=0,
                               atol=ATOL_PATHS)


def test_find_all_rays_weld_knobs_matches_jax_and_parallel(world):
    _, tf = _facades(world, WELD_KNOBS)
    kw = dict(subgrid_size=weld_data.SUBGRID, trans_pairs=world["pairs"],
              stif_den=world["stif"])
    got = tf.find_all_TTF_rays(*_model_args(world), **kw)
    want = world["jax"]["rays weld"].result()
    _compare_rays(want, tf, got, world["pairs"])
    # ray_path: trimmed, on the model grid, from transducer 0 to 3
    rx, ry = tf.ray_path(0, 3)
    wx, wy = want["path"]
    np.testing.assert_allclose(rx, wx, rtol=0, atol=ATOL_PATHS)
    np.testing.assert_allclose(ry, wy, rtol=0, atol=ATOL_PATHS)
    assert (rx[0], ry[0]) == (tf.isx[0], tf.isz[0])
    assert (rx[-1], ry[-1]) == (tf.isx[3], tf.isz[3])
    # the parallel method gives the same results
    paths = tf.ray_paths_x.copy(), tf.ray_paths_y.copy(), tf.ray_len.copy()
    par = tf.find_all_TTF_rays_parallel(*_model_args(world), **kw)
    np.testing.assert_array_equal(par, got)
    for a, b in zip(paths, (tf.ray_paths_x, tf.ray_paths_y, tf.ray_len)):
        np.testing.assert_array_equal(b, a)


def test_find_all_rays_default_knobs_matches_jax(world):
    """The facade's defaults (walk scorer, one cell per step) at
    subgrid_size = 3 on four pairs."""
    _, tf = _facades(world)
    kw = dict(subgrid_size=3, trans_pairs=DEFAULT_PAIRS,
              stif_den=world["stif"])
    got = tf.find_all_TTF_rays(*_model_args(world), **kw)
    _compare_rays(world["jax"]["rays default"].result(), tf, got,
                  DEFAULT_PAIRS)


def _bad_stif(w):
    return dict(stif_den=w["stif"].astype(np.int32))


def _bad_velpn(w):
    return dict(velpn=w["velpn"].astype(np.float64))


@pytest.mark.parametrize("bad, message", [
    (_bad_stif, "Stifness tensors and density array must have the type "
                "np.int64. 32bit integers will not work correctly."),
    (_bad_velpn, "velpn must be a numpy array of integers"),
])
def test_constructor_validation_matches_jax(world, bad, message):
    args = dict(veln=world["veln"], velpn=world["velpn"],
                vel_map=world["vel_map"], scx=world["sx"], scz=world["sy"],
                stif_den=world["stif"])
    args.update(bad(world))
    with pytest.raises(TypeError) as jerr:
        alifmm_tpu.ALI_FMM(**args)
    with pytest.raises(TypeError) as terr:
        alifmm_tpu_torch.ALI_FMM(device="cpu", **args)
    assert str(terr.value) == str(jerr.value) == message


def test_constructor_prints_mpa_warning_like_jax(world, capsys):
    stif = world["stif"] * 10**6
    args = (world["veln"], world["velpn"], world["vel_map"], world["sx"],
            world["sy"])
    alifmm_tpu.ALI_FMM(*args, stif_den=stif)
    want = capsys.readouterr().out
    alifmm_tpu_torch.ALI_FMM(*args, stif_den=stif, device="cpu")
    got = capsys.readouterr().out
    assert got == want and "must be in MPa" in got


def test_parallel_refuses_one_thread(world):
    jf, tf = _facades(world)
    for f in (jf, tf):
        with pytest.raises(Exception) as err:
            f.find_all_TTF_rays_parallel(*_model_args(world), n_threads=1)
        assert str(err.value) == ("n_threads must be greater than 1 for "
                                  "parallel computation")


def test_ray_path_without_rays(world, capsys):
    jf, tf = _facades(world)
    assert tf.ray_path(0, 3) == (None, None)
    got = capsys.readouterr().out
    assert jf.ray_path(0, 3) == (None, None)
    assert got == capsys.readouterr().out == (
        "Ray paths have not been calculated\n")
    # an untraced pair of a facade that has paths
    for f in (jf, tf):
        f.ray_paths_x = f.ray_paths_y = np.zeros((6, 6, 4))
        f.ray_len = np.zeros((6, 6), dtype=int)
    assert tf.ray_path(3, 0) == (None, None)
    got = capsys.readouterr().out
    assert jf.ray_path(3, 0) == (None, None)
    assert got == capsys.readouterr().out == (
        "Ray path has not been calculated for this pair\n")


def test_unknown_ray_opts_key_raises_like_jax():
    from alifmm_tpu import rays as jrays

    opts = dict(step_scale=3, no_such_knob=1)
    with pytest.raises(TypeError) as jerr:
        alifmm_tpu.ALI_FMM._route_ray_opts("search", jrays.trace_rays, opts)
    with pytest.raises(TypeError) as terr:
        alifmm_tpu_torch.ALI_FMM._route_ray_opts("search", trays.trace_rays,
                                                 opts)
    assert str(terr.value) == str(jerr.value)


def test_other_tracers_knob_warns_and_is_dropped_like_jax():
    from alifmm_tpu import rays as jrays

    opts = dict(step_scale=3, score_k=5, tol=1e-3)
    with pytest.warns(UserWarning) as jw:
        want = alifmm_tpu.ALI_FMM._route_ray_opts("search", jrays.trace_rays,
                                                  opts)
    with pytest.warns(UserWarning) as tw:
        got = alifmm_tpu_torch.ALI_FMM._route_ray_opts(
            "search", trays.trace_rays, opts)
    assert got == want == dict(step_scale=3)
    assert str(tw[0].message) == str(jw[0].message)


def test_unknown_key_raises_through_the_facade(world):
    _, tf = _facades(world, dict(no_such_knob=1))
    with pytest.raises(TypeError, match="no_such_knob"):
        tf.find_all_TTF_rays(*_model_args(world), stif_den=world["stif"])


def test_update_parallel_low_mem_writes_fields(world, tmp_path, monkeypatch):
    """low_mem saves each selected source's field and returns None; the
    solve behind it is ``update`` (held above) and is canned here."""
    _, tf = _facades(world)
    monkeypatch.chdir(tmp_path)
    mask = np.array([0, 1, 0, 1, 1, 0])
    canned = np.random.default_rng(5).uniform(size=(6,) + SHAPE)
    canned[mask == 0] = 0
    seen = []

    def fake_update(*args):
        seen.append(args)
        return canned

    monkeypatch.setattr(tf, "update", fake_update)
    out = tf.update_parallel(*_model_args(world), stif_den=world["stif"],
                             sources=mask, n_threads=4, low_mem=True)
    assert out is None and len(seen) == 1 and seen[0][5] is mask
    assert sorted(os.listdir(tmp_path)) == [
        "temp_TTF_1.npy", "temp_TTF_3.npy", "temp_TTF_4.npy"]
    for i in (1, 3, 4):
        np.testing.assert_array_equal(np.load(tmp_path / f"temp_TTF_{i}.npy"),
                                      canned[i])
    # without low_mem the fields come back and nothing is written
    monkeypatch.chdir(tmp_path.parent)
    full = tf.update_parallel(*_model_args(world), stif_den=world["stif"],
                              sources=mask)
    assert full is canned


@pytest.mark.parametrize("kw, where", [
    (dict(grid_mesh=object()), "init"),
])
def test_waiting_modes_raise_not_implemented(world, kw, where, monkeypatch):
    """No mode of the facade waits any more.  ``grid_mesh``, which raised
    NotImplementedError at init until the sharded solves were ported,
    now routes every field solve to parallel/shard.solve_ttf_halo with
    the mesh and the axis (the routing only: the halo solve itself is
    held to the JAX package in tests/test_torch_parallel.py)."""
    from alifmm_tpu_torch.parallel import shard

    seen = []

    def halo(model, scx, scz, mesh, axis, subgrid_size, cfg):
        seen.append((mesh, axis, subgrid_size, cfg))
        return torch.zeros((len(scx),) + model.shape, dtype=model.dtype)

    monkeypatch.setattr(shard, "solve_ttf_halo", halo)
    args = (world["veln"], world["velpn"], world["vel_map"], world["sx"],
            world["sy"])
    # a budget of its own, so the module's shared solves do not answer
    opts = dict(patch_max_passes=1, final_max_passes=1)
    f = alifmm_tpu_torch.ALI_FMM(*args, device="cpu", grid_axis="gz",
                                 solve_opts=opts, **kw)
    assert where == "init"
    out = f.update(*_model_args(world))
    assert out.shape == (len(world["sx"]),) + SHAPE and not out.any()
    assert seen == [(kw["grid_mesh"], "gz", 1,
                     tsolver.SolveConfig(**opts))]


def test_default_device_needs_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alifmm_tpu_torch.ALI_FMM(world["veln"], world["velpn"],
                                 world["vel_map"], world["sx"], world["sy"])
