"""PyTorch port, rays: trace_rays(mode="interp") with the production knobs,
relax_rays, ray_times and the segment integrators against the JAX package
on the same fields and model (float64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import rays as jrays
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import rays as trays
from alifmm_tpu_torch import weld_data

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
    # receiver fields: straight-ray times at 5790 m/s with a seeded
    # smooth perturbation (the tracer only needs a field per receiver)
    Z, X = SHAPE
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    rng = np.random.default_rng(7)
    fields = []
    for cx, cz in zip(scx, scz):
        r = np.hypot(zz - cz / weld_data.DNX, xx - cx / weld_data.DNX)
        bump = 1.0 + 0.05 * np.sin(zz / 7.0 + rng.uniform(0, 6)) * np.cos(xx / 9.0)
        fields.append(weld_data.DNX * r * bump / 5790.0)
    ttfs = np.stack(fields)
    return jm, tm, ttfs, src_xy, rec_xy, tidx


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
    for kw in (dict(mode="grid", quad_vel=3), dict(mode="interp"),
               dict(mode="interp", quad_vel=3, fast_step_scale=12)):
        with pytest.raises(NotImplementedError):
            trays.trace_rays(*args, **kw)
