"""PyTorch port, the descent and certified-auto tracers: _sample_ttf and
_sample_ttf_grad, trace_rays_descent (with and without its scored window,
on fields of the model grid and of the refined grid), trace_rays_auto,
split_at_cell_boundaries, the facade's tracer routing and its descent and
auto tracers, against the JAX package on the same inputs (float64, the
port on the CPU through its plain twins); and utils/io and
utils/profiling.

The receiver fields are synthetic (straight-ray times with a seeded
smooth bump, or the exact field of a homogeneous medium): the tracers
need a field per receiver, not a solve, and the facade's solve is
replaced by the same fields in both packages.  Tolerances: vertices 1e-9
fine cells, times 1e-9 relative (same float64 operations; sums may
reassociate), lengths and reasons equal; facade time matrices 1e-8
relative as in tests/test_torch_api.py."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import alifmm_tpu
import alifmm_tpu_torch
from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu import rays as jrays
from alifmm_tpu.utils import io as jio
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.utils import io as tio
from alifmm_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-9
ATOL_VERTEX = 1e-9
RTOL_MATRIX = 1e-8
S = weld_data.SUBGRID
SHAPE = (48, 56)
DESCENT_KNOBS = dict(max_cross=8, relax_iters=1, relax_quad=3)
# the plane search's production knobs with a short step buffer (the
# retrace of the auto tracer)
SEARCH_KNOBS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                    relax_iters=1, relax_quad=3, max_steps=20,
                    cand_stride=7.0)
WELD_STIF = (263000, 148000, 216000, 129000, 8100)  # MPa, kg m^-3


def _fields(scx, scz, seed, s=1):
    """Receiver fields on the grid refined ``s`` times: straight-ray times
    at 5790 m/s with a seeded smooth perturbation."""
    Z, X = SHAPE
    zz, xx = np.meshgrid(np.arange((Z - 1) * s + 1) / s,
                         np.arange((X - 1) * s + 1) / s, indexing="ij")
    rng = np.random.default_rng(seed)
    out = []
    for cx, cz in zip(scx, scz):
        r = np.hypot(zz - cz / weld_data.DNX, xx - cx / weld_data.DNX)
        bump = 1.0 + 0.05 * np.sin(zz / 7.0 + rng.uniform(0, 6)) * np.cos(
            xx / 9.0)
        out.append(weld_data.DNX * r * bump / 5790.0)
    return np.stack(out)


def _models(veln, velpn, vel_map, stif, dnx):
    return (jgrid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                             dtype=jnp.float64),
            tgrid.make_model(veln, velpn, vel_map, stif, None, None, dnx,
                             dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def weld():
    """The 48 x 56 weld, 5 + 5 transducers (25 rays, 5 receiver fields)."""
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(4, SHAPE)
    jm, tm = _models(veln, velpn, vel_map, stif, weld_data.DNX)
    sx, sy, pairs = weld_data.transducers(SHAPE, weld_data.DNX, 5, 10)
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs)
    return dict(jm=jm, tm=tm, scx=scx, scz=scz, src=src_xy, rec=rec_xy,
                tidx=tidx, arrays=(veln, velpn, vel_map, stif), sx=sx, sy=sy,
                pairs=pairs)


def _jax_args(fields, w):
    return (jnp.asarray(fields), jnp.asarray(w["tidx"]), jnp.asarray(w["src"]),
            jnp.asarray(w["rec"]))


def _torch_args(fields, w):
    return (torch.from_numpy(fields), torch.from_numpy(w["tidx"]),
            torch.from_numpy(w["src"]), torch.from_numpy(w["rec"]))


def _same_rays(got, want, what):
    """Padded polylines, lengths, times (and reasons) as stated above."""
    got = [a.numpy() for a in got]
    want = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(got[2], want[2], err_msg=f"{what} lengths")
    if len(want) > 4:
        np.testing.assert_array_equal(got[4], want[4],
                                      err_msg=f"{what} reasons")
    W = min(got[0].shape[1], want[0].shape[1])
    for k, name in ((0, "x"), (1, "y")):
        np.testing.assert_allclose(got[k][:, :W], want[k][:, :W], rtol=0,
                                   atol=ATOL_VERTEX, err_msg=f"{what} {name}")
        assert not got[k][:, W:].any() and not want[k][:, W:].any()
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=0,
                               err_msg=f"{what} times")


@pytest.mark.parametrize("mode", ["interp", "grid"])
def test_sample_ttf_and_gradient_match_jax(weld, mode):
    """Both samplers on one field at seeded points inside and past the
    grid, half-integers among them (grid mode rounds half to even)."""
    s = 1 if mode == "grid" else S
    field = _fields(weld["scx"][:1], weld["scz"][:1], 3, S if mode == "grid"
                    else 1)[0]
    rng = np.random.default_rng(5)
    Z, X = field.shape
    x = np.concatenate([rng.uniform(-5, s * X + 5, 40),
                        np.arange(8) + 0.5])
    y = np.concatenate([rng.uniform(-5, s * Z + 5, 40),
                        np.arange(8) * 2.5])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = jrays._sample_ttf(jnp.asarray(field), jnp.asarray(x),
                             jnp.asarray(y), S, mode)
    got = trays._sample_ttf(torch.from_numpy(field), tx, ty, S, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)
    want = jrays._sample_ttf_grad(jnp.asarray(field), jnp.asarray(x),
                                  jnp.asarray(y), S, mode)
    got = trays._sample_ttf_grad(torch.from_numpy(field), tx, ty, S, mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-18)


@pytest.mark.parametrize("veln_deg", [0.0, 30.0, 75.0, 120.0])
def test_descent_follows_straight_rays_homogeneous(veln_deg):
    """tests/test_rays_descent.py's straight-ray cases: a homogeneous
    stiffness medium, its exact field from the receiver, three rays; the
    port equals JAX and stays within a cell of the chord."""
    Z = X = 61
    dnx = 1e-3
    stif = np.zeros((Z, X, 5), dtype=np.int64)
    stif[:, :] = WELD_STIF
    jm, tm = _models(np.full((Z, X), veln_deg), np.zeros((Z, X), dtype=int),
                     np.ones((Z, X)), stif, dnx)
    rx, ry = 30, 5
    yy, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    dx, dy = xx - rx, yy - ry
    ang = np.degrees(np.arctan2(dy, np.where(dx == 0, 1e-12, dx)))
    v = np.asarray(jmats.group_velocity_christoffel(
        jnp.asarray(np.mod(veln_deg - ang, 180.0)), *WELD_STIF))
    ttf = (dnx * np.hypot(dx, dy) / v)[None]
    src = np.array([[8.0, 55.0], [50.0, 52.0], [5.0, 30.0]])
    rec = np.array([[float(rx), float(ry)]] * 3)
    kw = dict(mode="grid", step_scale=2.0, relax_iters=0, return_reason=True)
    want = jrays.trace_rays_descent(jm, jnp.asarray(ttf),
                                    jnp.zeros(3, jnp.int32), jnp.asarray(src),
                                    jnp.asarray(rec), 1, **kw)
    got = trays.trace_rays_descent(tm, torch.from_numpy(ttf),
                                   torch.zeros(3, dtype=torch.int64),
                                   torch.from_numpy(src),
                                   torch.from_numpy(rec), 1, **kw)
    _same_rays(got, want, f"veln {veln_deg}")
    bx, by, lens = (a.numpy() for a in got[:3])
    for r in range(3):
        n = lens[r]
        p0 = np.array([bx[r, 0], by[r, 0]])
        chord = np.array([bx[r, n - 1], by[r, n - 1]]) - p0
        perp = np.abs(chord[0] * (by[r, :n] - p0[1])
                      - chord[1] * (bx[r, :n] - p0[0])) / np.hypot(*chord)
        assert perp.max() < 1.0, (veln_deg, r, perp.max())


@pytest.mark.parametrize("score_k", [0, 5])
@pytest.mark.parametrize("mode", ["interp", "grid"])
def test_trace_rays_descent_matches_jax(weld, mode, score_k):
    """The weld 48 x 56, 25 rays through fields of the model grid
    (interp) or of the grid refined 9x (grid); the scored window moves
    some rays (its polylines differ from the unscored march's)."""
    fields = _fields(weld["scx"], weld["scz"], 7, S if mode == "grid" else 1)
    kw = dict(DESCENT_KNOBS, mode=mode, return_reason=True)
    want = jrays.trace_rays_descent(weld["jm"], *_jax_args(fields, weld), S,
                                    score_k=score_k, **kw)
    got = trays.trace_rays_descent(weld["tm"], *_torch_args(fields, weld), S,
                                   score_k=score_k, **kw)
    _same_rays(got, want, f"{mode} score_k={score_k}")
    lens, times, reason = got[2].numpy(), got[3].numpy(), got[4].numpy()
    assert lens.min() > 3 and np.all(times > 0) and not reason.any()
    if score_k:
        plain = trays.trace_rays_descent(weld["tm"],
                                         *_torch_args(fields, weld), S,
                                         score_k=0, **kw)
        assert not torch.equal(plain[0], got[0])


def test_even_score_k_raises(weld):
    fields = _fields(weld["scx"], weld["scz"], 7)
    with pytest.raises(ValueError, match="odd"):
        jrays.trace_rays_descent(weld["jm"], *_jax_args(fields, weld), S,
                                 score_k=4)
    with pytest.raises(ValueError, match="odd"):
        trays.trace_rays_descent(weld["tm"], *_torch_args(fields, weld), S,
                                 score_k=4)


def _flagged(times, t_true, tol):
    return np.nonzero(~(np.asarray(times) <= (1.0 + tol)
                        * np.asarray(t_true)))[0]


def _auto_case(weld, which):
    """The fields, both packages' arguments, the descent's result and a
    ``tol`` for the certificate: between two ratios of descent time to
    first arrival ("some": about half the rays flagged), or above the
    largest ("none")."""
    fields = _fields(weld["scx"], weld["scz"], 7)
    jargs, targs = _jax_args(fields, weld), _torch_args(fields, weld)
    jd = jrays.trace_rays_descent(weld["jm"], *jargs, S, **DESCENT_KNOBS)
    j_true = jax.vmap(lambda i, x, y: jrays._sample_ttf(
        jargs[0][i], x, y, S, "interp"))(jargs[1], jargs[2][:, 0],
                                         jargs[2][:, 1])
    td = trays.trace_rays_descent(weld["tm"], *targs, S, **DESCENT_KNOBS)
    t_true = trays._sample_ttf(targs[0], targs[2][:, 0], targs[2][:, 1], S,
                               "interp", targs[1])
    ratio = np.sort(td[3].numpy() / t_true.numpy())
    n = len(ratio)
    tol = ((ratio[n // 2 - 1] + ratio[n // 2]) / 2 - 1 if which == "some"
           else ratio[-1] * 1.01 - 1)
    flagged = _flagged(td[3].numpy(), t_true.numpy(), tol)
    np.testing.assert_array_equal(flagged, _flagged(jd[3], j_true, tol))
    return jargs, targs, td, tol, flagged


@pytest.mark.parametrize("which", ["some", "none"])
def test_trace_rays_auto_matches_jax(weld, which):
    """The certificate flags the same rays in both packages (a ``tol``
    between two ratios of descent time to first arrival flags about half,
    one above the largest flags none), and the retraced result is the
    same: JAX in chunks of 4 rays, the last one padded by repetition."""
    jargs, targs, td, tol, flagged = _auto_case(weld, which)
    n = len(td[3])
    if which == "some":
        assert 0 < len(flagged) < n and len(flagged) % 4
    else:
        assert len(flagged) == 0
    kw = dict(tol=tol, retrace_chunk=4, descent_kw=DESCENT_KNOBS,
              search_kw=SEARCH_KNOBS)
    want = jrays.trace_rays_auto(weld["jm"], *jargs, S, **kw)
    got = trays.trace_rays_auto(weld["tm"], *targs, S, **kw)
    _same_rays(got, want, f"auto ({which} flagged)")
    changed = np.nonzero(got[3].numpy() != td[3].numpy())[0]
    assert set(changed) <= set(flagged)
    if which == "none":
        for g, d in zip(got, td):
            assert torch.equal(g, d)


@pytest.mark.parametrize("chunk", [2, 128])
def test_trace_rays_auto_is_independent_of_chunking(weld, chunk):
    """The port retraces every flagged ray in one call; JAX in chunks of
    ``retrace_chunk`` (2: many chunks, the last padded; 128: one chunk
    mostly padding).  Ray for ray the results are the same, and some
    flagged rays are replaced."""
    jargs, targs, td, tol, flagged = _auto_case(weld, "some")
    assert len(flagged) > chunk or chunk > len(td[3])
    kw = dict(tol=tol, retrace_chunk=chunk, descent_kw=DESCENT_KNOBS,
              search_kw=SEARCH_KNOBS)
    want = jrays.trace_rays_auto(weld["jm"], *jargs, S, **kw)
    got = trays.trace_rays_auto(weld["tm"], *targs, S, **kw)
    _same_rays(got, want, f"auto, JAX in chunks of {chunk}")
    changed = np.nonzero(got[3].numpy() != td[3].numpy())[0]
    assert len(changed) and set(changed) <= set(flagged)


def test_split_at_cell_boundaries_matches_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, 40, 12), [7.0, 7.0, 12.5]])
    y = np.concatenate([rng.uniform(0, 30, 12), [3.0, 9.0, 9.0]])
    want = jrays.split_at_cell_boundaries(jnp.asarray(x), jnp.asarray(y), 24)
    got = trays.split_at_cell_boundaries(torch.from_numpy(x),
                                         torch.from_numpy(y), 24)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    valid = np.asarray(want[2])
    assert valid.any() and not valid.all()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid],
                                   rtol=RTOL, atol=1e-12)


ROUTE_OPTS = dict(max_cross=8, step_scale=6, quad_vel=3, score_k=5,
                  tol=1e-3, descent_kw=dict(relax_iters=0, step_scale=4),
                  search_kw=dict(max_steps=10))


@pytest.mark.parametrize("tracer", ["search", "descent", "auto"])
def test_route_ray_opts_matches_jax(tracer):
    """The same routed knobs and the same warnings as the JAX facade; a key
    no tracer accepts raises TypeError in both."""
    fns = {"search": (jrays.trace_rays, trays.trace_rays),
           "descent": (jrays.trace_rays_descent, trays.trace_rays_descent),
           "auto": (jrays.trace_rays_auto, trays.trace_rays_auto)}[tracer]
    out = []
    for facade, fn in zip((alifmm_tpu.ALI_FMM, alifmm_tpu_torch.ALI_FMM),
                          fns):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            routed = facade._route_ray_opts(tracer, fn, dict(ROUTE_OPTS))
        out.append((routed, [str(w.message) for w in caught]))
        with pytest.raises(TypeError, match="unknown ray_opts"):
            facade._route_ray_opts(tracer, fn, dict(ROUTE_OPTS, speed=1))
    assert out[0] == out[1]
    # "auto" passes every knob on to one of its tracers; the others drop
    assert bool(out[0][1]) == (tracer != "auto")


@pytest.mark.parametrize("tracer", ["descent", "auto"])
def test_facade_tracers_match_jax(weld, tracer, monkeypatch):
    """``ALI_FMM.find_all_TTF_rays`` with ``tracer`` on the 48 x 56 weld,
    every pair of its 10 transducers (45 rays), the solve replaced in both
    facades by the synthetic fields of the receivers asked for."""
    veln, velpn, vel_map, stif = weld["arrays"]
    opts = dict(DESCENT_KNOBS, tracer=tracer, step_scale=6, score_k=3)
    if tracer == "auto":
        opts.update(retrace_chunk=8, tol=1e-3,
                    search_kw=dict(SEARCH_KNOBS, step_scale=9))
    out = []
    for pkg, wrap in ((alifmm_tpu, jnp.asarray),
                      (alifmm_tpu_torch, torch.from_numpy)):
        kw = dict(device="cpu") if pkg is alifmm_tpu_torch else {}
        fm = pkg.ALI_FMM(veln, velpn, vel_map, weld["sx"], weld["sy"],
                         stif_den=stif, dnx=weld_data.DNX, dtype=(
                             torch.float64 if pkg is alifmm_tpu_torch
                             else jnp.float64), ray_opts=opts, **kw)
        monkeypatch.setattr(fm, "_solve_fields", lambda model, scx, scz, s,
                            progress=None, wrap=wrap: wrap(_fields(scx, scz,
                                                                   11)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tmat = fm.find_all_TTF_rays(veln, velpn, vel_map, stif_den=stif,
                                        subgrid_size=S)
        out.append((tmat, fm.ray_len, fm.ray_paths_x, fm.ray_paths_y))
    (wt, wl, wx, wy), (gt, gl, gx, gy) = out
    assert np.count_nonzero(wt) == 45 and np.all(wt[wl > 0] > 0)
    np.testing.assert_allclose(gt, wt, rtol=RTOL_MATRIX, atol=0)
    np.testing.assert_array_equal(gl, wl)
    W = min(gx.shape[2], wx.shape[2])
    np.testing.assert_allclose(gx[..., :W], wx[..., :W], rtol=0, atol=1e-9)
    np.testing.assert_allclose(gy[..., :W], wy[..., :W], rtol=0, atol=1e-9)


def test_io_round_trip(tmp_path):
    """Fields and rays saved by the port load back equal, and load with
    the JAX package's readers (the same files and keys), and back."""
    rng = np.random.default_rng(0)
    fields = torch.from_numpy(rng.uniform(size=(3, 5, 6)))
    tio.save_fields(tmp_path / "f.npz", fields, [4, 1, 7])
    for load in (tio.load_fields, jio.load_fields):
        f, idx = load(tmp_path / "f.npz")
        np.testing.assert_array_equal(f, fields.numpy())
        np.testing.assert_array_equal(idx, [4, 1, 7])
    tio.save_fields(tmp_path / "g.npz", fields.numpy())
    np.testing.assert_array_equal(tio.load_fields(tmp_path / "g.npz")[1],
                                  [0, 1, 2])
    times = rng.uniform(size=(4, 4))
    px, py = rng.uniform(size=(2, 4, 4, 9))
    ray_len = rng.integers(0, 7, (4, 4))
    for save, load in ((tio.save_rays, jio.load_rays),
                       (jio.save_rays, tio.load_rays)):
        out = tmp_path / save.__module__.split(".")[0]
        save(str(out), torch.from_numpy(times) if save is tio.save_rays
             else times, px, py, ray_len)
        t, x, y, n = load(str(out))
        np.testing.assert_array_equal(t, times)
        np.testing.assert_array_equal(x, px[:, :, :ray_len.max()])
        np.testing.assert_array_equal(y, py[:, :, :ray_len.max()])
        np.testing.assert_array_equal(n, ray_len)


def test_trace_on_the_cpu(tmp_path):
    veln = np.zeros((4, 5))
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(4) @ torch.ones(4)
        tgrid.make_model(veln, np.ones((4, 5), np.int32), device="cpu")
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"alifmm.build", "alifmm.build.planes", "alifmm.build.tables",
            "alifmm.build.upload"} <= names


def test_build_hash_follows_included_headers(tmp_path):
    """A kernel library is keyed by its source and every local header the
    source includes: editing the shared header rebuilds K2, K3 and K4."""
    from alifmm_tpu_torch.ops import _build

    for name in ("descent.cu", "rays.cu", "ray_device.cuh"):
        (tmp_path / name).write_bytes(
            open(os.path.join(_build.CSRC, name), "rb").read())
    files = [os.path.basename(p) for p in _build.source_files(
        str(tmp_path / "descent.cu"))]
    assert files == ["descent.cu", "ray_device.cuh"]
    before = _build.source_digest(str(tmp_path / "descent.cu"))
    with open(tmp_path / "ray_device.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build.source_digest(str(tmp_path / "descent.cu")) != before
