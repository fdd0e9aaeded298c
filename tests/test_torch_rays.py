"""PyTorch port, rays: trace_rays(mode="interp") with the production knobs
and with the walk scorer, relax_rays, ray_times, K3's composed twin and the
segment integrators against the JAX package on the same fields and model
(float64), the first-wins selections on inputs built to tie, the in-place
waves on which K3 rests, and the kernels' floor-mod by 180."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import rays as jrays
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.ops import cuda_rays

RTOL = 1e-9  # same float64 operations; sums may reassociate (ulps)
S = weld_data.SUBGRID
SHAPE = (48, 56)
# the production march knobs, with a short step buffer
RAY_OPTS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                relax_iters=1, relax_quad=3, max_steps=20, cand_stride=7.0)


@pytest.fixture(scope="module")
def setup():
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(4, SHAPE)
    jm = jgrid.make_model(veln, velpn, vel_map, stif, None, None,
                          weld_data.DNX, dtype=jnp.float64)
    tm = tgrid.make_model(veln, velpn, vel_map, stif, None, None,
                          weld_data.DNX, dtype=torch.float64, device="cpu")
    sx, sy, pairs = weld_data.transducers(SHAPE, weld_data.DNX, 3, 15)
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs)
    return jm, tm, _fields(scx, scz, 7), src_xy, rec_xy, tidx


def _fields(scx, scz, seed):
    """Receiver fields: straight-ray times at 5790 m/s with a seeded
    smooth perturbation (the tracer only needs a field per receiver)."""
    Z, X = SHAPE
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    rng = np.random.default_rng(seed)
    fields = []
    for cx, cz in zip(scx, scz):
        r = np.hypot(zz - cz / weld_data.DNX, xx - cx / weld_data.DNX)
        bump = 1.0 + 0.05 * np.sin(zz / 7.0 + rng.uniform(0, 6)) * np.cos(xx / 9.0)
        fields.append(weld_data.DNX * r * bump / 5790.0)
    return np.stack(fields)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12,
                               err_msg=what)


def test_trace_rays_matches_jax(setup):
    jm, tm, ttfs, src_xy, rec_xy, tidx = setup
    want = jrays.trace_rays(jm, jnp.asarray(ttfs), jnp.asarray(tidx),
                            jnp.asarray(src_xy), jnp.asarray(rec_xy), S,
                            mode="interp", return_reason=True, **RAY_OPTS)
    got = trays.trace_rays(tm, torch.from_numpy(ttfs), torch.from_numpy(tidx),
                           torch.from_numpy(src_xy), torch.from_numpy(rec_xy),
                           S, mode="interp", return_reason=True, **RAY_OPTS)
    wx, wy, wlen, wt, wr = (np.asarray(a) for a in want)
    gx, gy, glen, gt, gr = (a.numpy() for a in got)
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gr, wr)
    _close(gx, wx, "ray_x")
    _close(gy, wy, "ray_y")
    _close(gt, wt, "times")
    assert wlen.min() > 3 and np.all(wt > 0)


def _polylines(src_xy, rec_xy, P, seed):
    """Jittered straight polylines with ragged lengths (receiver appended
    at lengths - 1, zero padding beyond, as trace_rays leaves them)."""
    rng = np.random.default_rng(seed)
    R = src_xy.shape[0]
    lengths = rng.integers(4, P + 1, R)
    x = np.zeros((R, P))
    y = np.zeros((R, P))
    for r in range(R):
        n = lengths[r]
        f = np.linspace(0.0, 1.0, n)
        x[r, :n] = src_xy[r, 0] + f * (rec_xy[r, 0] - src_xy[r, 0])
        y[r, :n] = src_xy[r, 1] + f * (rec_xy[r, 1] - src_xy[r, 1])
        x[r, 1:n - 1] += rng.uniform(-6, 6, n - 2)
        y[r, 1:n - 1] += rng.uniform(-6, 6, n - 2)
    return x, y, lengths


@pytest.mark.parametrize("quad", [3, 0])
def test_relax_rays_matches_jax(setup, quad):
    jm, tm, _, src_xy, rec_xy, _ = setup
    x, y, lengths = _polylines(src_xy, rec_xy, 12, seed=quad)
    jmf = jrays._material_flat(jm)
    tmf = trays._material_flat(tm)
    wx, wy = jrays.relax_rays(jm, jmf, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(lengths), S, iters=1, max_cross=13,
                              quad=quad, chunk=10)
    gx, gy = trays.relax_rays(tm, tmf, torch.from_numpy(x),
                              torch.from_numpy(y), torch.from_numpy(lengths),
                              S, iters=1, max_cross=13, quad=quad)
    _close(gx.numpy(), np.asarray(wx), "relaxed x")
    _close(gy.numpy(), np.asarray(wy), "relaxed y")
    assert np.any(np.asarray(wx) != x)


def test_ray_times_matches_jax(setup):
    jm, tm, _, src_xy, rec_xy, _ = setup
    x, y, lengths = _polylines(src_xy, rec_xy, 12, seed=11)
    want = jrays.ray_times(jm, jrays._material_flat(jm), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(lengths), S, 13,
                           chunk=11)
    got = trays.ray_times(tm, trays._material_flat(tm), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(lengths), S,
                          13)
    _close(got.numpy(), np.asarray(want), "ray times")


@pytest.mark.parametrize("quad", [3, 0], ids=["simpson3", "exact"])
@pytest.mark.parametrize("iters", [0, 1, 2])
def test_relax_and_times_matches_jax(setup, iters, quad):
    """K3's plain twin (``iters`` odd-even wave pairs, then the ray times,
    through the wrapper's CPU path) against JAX's relax_rays, then
    ray_times."""
    jm, tm, _, src_xy, rec_xy, _ = setup
    x, y, lengths = _polylines(src_xy, rec_xy, 12, seed=20 + iters)
    jmf = jrays._material_flat(jm)
    wx, wy = jnp.asarray(x), jnp.asarray(y)
    if iters:
        wx, wy = jrays.relax_rays(jm, jmf, wx, wy, jnp.asarray(lengths), S,
                                  iters=iters, max_cross=13, quad=quad,
                                  chunk=10)
    wt = jrays.ray_times(jm, jmf, wx, wy, jnp.asarray(lengths), S, 9,
                         chunk=11)
    gx, gy, gt = cuda_rays.relax_and_times(
        tm, trays._material_flat(tm), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(lengths), S, 2 * iters,
        relax_cross=13, quad=quad, times_cross=9)
    _close(gx.numpy(), np.asarray(wx), "relaxed x")
    _close(gy.numpy(), np.asarray(wy), "relaxed y")
    _close(gt.numpy(), np.asarray(wt), "ray times")
    assert np.any(np.asarray(wx) != x) == (iters > 0)


def _wave_in_place(tm, tmf, xs, ys, lengths, parity, order, quad):
    """One wave run in place, one vertex at a time in ``order``: each
    vertex moves as the map would move it, but reads the neighbours as the
    vertices before it in ``order`` left them (what one block running a
    wave in place may see).  ``parity`` None moves every vertex."""
    xs, ys = xs.clone(), ys.clone()
    for v in order:
        p = v % 2 if parity is None else parity
        if v % 2 != p:
            continue
        mx, my = trays.relax_wave_plain(tm, tmf, xs, ys, lengths, S, p,
                                        float(S), 13, quad)
        xs[:, v], ys[:, v] = mx[:, v], my[:, v]
    return xs, ys


@pytest.mark.parametrize("quad", [3, 0], ids=["simpson3", "exact"])
def test_waves_in_place_equal_the_map(setup, quad):
    """A wave moves vertices of one parity using their neighbours, which
    are of the other parity and stay put, so K3 may run the waves of
    ``relax_rays`` in place: vertex by vertex in reversed order this
    gives the bits of the map.  Moving both parities in one wave does
    not."""
    _, tm, _, src_xy, rec_xy, _ = setup
    tmf = trays._material_flat(tm)
    x, y, lengths = _polylines(src_xy, rec_xy, 12, seed=31)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    lengths = torch.from_numpy(lengths)
    order = range(10, 0, -1)
    mx, my, ix, iy = xs, ys, xs, ys
    for parity in [1, 0] * 2:
        mx, my = trays.relax_wave_plain(tm, tmf, mx, my, lengths, S, parity,
                                        float(S), 13, quad)
        ix, iy = _wave_in_place(tm, tmf, ix, iy, lengths, parity, order,
                                quad)
        assert torch.equal(ix, mx) and torch.equal(iy, my)
    assert not torch.equal(mx, xs)
    bx, by = _wave_in_place(tm, tmf, xs, ys, lengths, None, order, quad)
    wx, wy = trays.relax_wave_plain(tm, tmf, xs, ys, lengths, S, 1, float(S),
                                    13, quad)
    wx, wy = trays.relax_wave_plain(tm, tmf, wx, wy, lengths, S, 0, float(S),
                                    13, quad)
    assert not (torch.equal(bx, wx) and torch.equal(by, wy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mod180_equals_remainder_bit_for_bit(dtype):
    """The kernels' floor-mod by 180 (one compare and one add below 360 in
    magnitude, fmod beyond) is torch.remainder(x, 180) in every bit,
    signed zeros included (-180 and -360 give -0)."""
    special = torch.tensor([0.0, 180.0, 359.99, 360.0, 360.01, 540.0, 720.0,
                            179.99999, 90.0, 1e-30, 1e6, float("inf"),
                            float("nan")], dtype=dtype)
    special = torch.cat([special, -special])
    up = torch.nextafter(special, torch.full_like(special, float("inf")))
    down = torch.nextafter(special, torch.full_like(special, -float("inf")))
    rng = np.random.default_rng(180)
    seeded = torch.from_numpy(rng.uniform(-1000.0, 1000.0, 100_000)).to(dtype)
    x = torch.cat([special, up, down, seeded])
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    got = trays.mod180(x).view(bits)
    want = torch.remainder(x, 180.0).view(bits)
    nan = torch.isnan(x) | torch.isinf(x)
    assert torch.equal(got[~nan], want[~nan])
    assert bool(torch.isnan(trays.mod180(x)[nan]).all())
    zero = trays.mod180(torch.tensor([-180.0, -360.0, 180.0], dtype=dtype))
    assert torch.equal(torch.signbit(zero), torch.tensor([True, True, False]))


def test_segment_integrators_match_jax(setup):
    jm, tm, _, _, _, _ = setup
    rng = np.random.default_rng(3)
    Z, X = SHAPE
    n = 64
    pts = [rng.uniform(0, (X - 1) * S, n), rng.uniform(0, (Z - 1) * S, n),
           rng.uniform(0, (X - 1) * S, n), rng.uniform(0, (Z - 1) * S, n)]
    pts[2][:4] = pts[0][:4]  # vertical segments
    jmf, tmf = jrays._material_flat(jm), trays._material_flat(tm)
    jp = [jnp.asarray(p) for p in pts]
    tp = [torch.from_numpy(p) for p in pts]
    _close(trays.segment_time(tm, tmf, *tp, S, 40).numpy(),
           np.asarray(jrays.segment_time(jm, jmf, *jp, S, 40)), "segment")
    _close(trays.segment_time_quad3(tm, tmf, *tp, S).numpy(),
           np.asarray(jrays.segment_time_quad3(jm, jmf, *jp, S)), "simpson3")
    _close(trays.segment_time_quad(tm, tmf, *tp, S).numpy(),
           np.asarray(jrays.segment_time_quad(jm, jmf, *jp, S)), "simpson5")


def test_unported_modes_raise(setup):
    jm, tm, ttfs, src_xy, rec_xy, tidx = setup
    args = (tm, torch.from_numpy(ttfs), torch.from_numpy(tidx),
            torch.from_numpy(src_xy), torch.from_numpy(rec_xy), S)
    for kw in (dict(mode="grid", quad_vel=3),
               dict(mode="interp", exact_materials=True),
               dict(mode="interp", quad_vel=3, fast_step_scale=12)):
        with pytest.raises(NotImplementedError):
            trays.trace_rays(*args, **kw)


@pytest.mark.parametrize("max_cross", [16, 5])
def test_walk_integrator_matches_jax(setup, max_cross):
    """_segment_time_walk, also with fewer crossings than the segments
    have (the walk stops short) and on vertical, horizontal and
    zero-length segments."""
    jm, tm, _, _, _, _ = setup
    rng = np.random.default_rng(5)
    Z, X = SHAPE
    n = 96
    x1 = rng.uniform(0, (X - 1) * S, n)
    y1 = rng.uniform(0, (Z - 1) * S, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.uniform(0, 4 * S, n)
    x2 = x1 + length * np.cos(ang)
    y2 = y1 + length * np.sin(ang)
    x2[:8] = x1[:8]
    y2[8:16] = y1[8:16]
    x2[16:20], y2[16:20] = x1[16:20], y1[16:20]
    pts = [x1, y1, x2, y2]
    for a in pts:
        a[20:40] = np.round(a[20:40])
    want = jrays._segment_time_walk(jm, jrays._material_flat(jm),
                                    *(jnp.asarray(p) for p in pts), S,
                                    max_cross)
    got = trays._segment_time_walk(tm, trays._material_flat(tm),
                                   *(torch.from_numpy(p) for p in pts), S,
                                   max_cross)
    _close(got.numpy(), np.asarray(want), "walk")
    assert np.all(np.asarray(want)[16:20] == 0) and np.asarray(want).max() > 0


@pytest.mark.parametrize("knobs", [
    dict(max_steps=140),
    dict(step_scale=2, max_cross=8, relax_iters=1, relax_quad=False),
], ids=["defaults", "two cells a step, exact relaxation"])
def test_trace_rays_walk_scorer_matches_jax(setup, knobs):
    """quad_vel=False (the facade's default): candidates scored by the
    crossing walk, at 3 fine cells per model cell.  JAX's CPU build
    contracts the walk's multiply-adds, so the two walks differ in their
    last bits (1e-14 relative); the fields' seed is one where no two
    candidate minima are that close."""
    jm, tm, _, src_xy, rec_xy, tidx = setup
    sx, sy, pairs = weld_data.transducers(SHAPE, weld_data.DNX, 3, 15)
    ttfs = _fields(*weld_data.ray_pairs(sx, sy, pairs)[:2], seed=8)
    s = 3
    src, rec = src_xy / S * s, rec_xy / S * s
    want = jrays.trace_rays(jm, jnp.asarray(ttfs), jnp.asarray(tidx),
                            jnp.asarray(src), jnp.asarray(rec), s,
                            mode="interp", return_reason=True, **knobs)
    got = trays.trace_rays(tm, torch.from_numpy(ttfs), torch.from_numpy(tidx),
                           torch.from_numpy(src), torch.from_numpy(rec), s,
                           mode="interp", return_reason=True, **knobs)
    wx, wy, wlen, wt, wr = (np.asarray(a) for a in want)
    gx, gy, glen, gt, gr = (a.numpy() for a in got)
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gr, wr)
    _close(gx, wx, "ray_x")
    _close(gy, wy, "ray_y")
    _close(gt, wt, "times")
    assert wlen.min() > 10 and np.all(wt > 0)


def test_first_wins_selections_match_jax_on_ties():
    """argmax over the four plane scores and argmin over the interior
    minima take the first of equal values, as jnp.argmax / jnp.argmin."""
    # vec_x == 0 ties scores 1 and 3; vec == 0 ties all four; |vx| == |vy|
    # ties scores 0 and 2
    vec_x = np.array([0.0, 0.0, 3.0, -3.0, 2.0, 0.0, 5.0])
    vec_y = np.array([4.0, 0.0, 3.0, 3.0, -7.0, -1.0, 0.0])
    r2 = np.sqrt(2.0)
    rows = [np.abs(vec_x), np.abs(vec_x + vec_y) / r2, np.abs(vec_y),
            np.abs(vec_x - vec_y) / r2]
    rows.append(rows[0].copy())  # a fifth row that ties the first
    want = np.asarray(jnp.argmax(jnp.stack([jnp.asarray(r) for r in rows]),
                                 axis=0))
    got = trays._argmax_first([torch.from_numpy(r) for r in rows]).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 0 and got[0] == 2

    big = 1.0e30
    val = np.array([
        [big, 2.0, 2.0, big, 2.0],     # a flat valley: three equal minima
        [big, big, big, big, big],     # no interior minimum at all
        [5.0, 1.0, 7.0, 1.0, 1.0],
        [3.0, 3.0, 3.0, 3.0, 3.0],
        [9.0, 8.0, 7.0, 6.0, 6.0],
    ])
    want = np.asarray(jnp.argmin(jnp.asarray(val), axis=1))
    got = trays._argmin_first(torch.from_numpy(val)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 1, 0, 3])


def test_plain_steps_are_counted(setup):
    jm, tm, ttfs, src_xy, rec_xy, tidx = setup
    before = trays.PLAIN_STEPS
    out = trays.trace_rays(tm, torch.from_numpy(ttfs), torch.from_numpy(tidx),
                           torch.from_numpy(src_xy), torch.from_numpy(rec_xy),
                           S, mode="interp", **RAY_OPTS)
    steps = trays.PLAIN_STEPS - before
    assert 0 < steps <= RAY_OPTS["max_steps"]
    assert steps >= int(out[2].max()) - 2
