"""PyTorch port, model layer: make_model / model_from_numpy / velocity
dispatch against the JAX package on the same seeded inputs (float64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import weld_data
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-12  # host precompute is the same numpy code: ulp-level only


def _weld_inputs():
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(1, (24, 30))
    return (veln, velpn, vel_map, stif, None, None)


def _table_inputs():
    """Anisotropic table materials (varying columns), no stiffness."""
    rng = np.random.default_rng(5)
    Z, X = 18, 22
    g = np.zeros((361, 3))
    p = np.zeros((361, 3))
    g[:, 0] = p[:, 0] = np.arange(361)
    for m, c in enumerate([(263e9, 145e9, 216e9, 129e9, 7800.0),
                           (240e9, 120e9, 250e9, 110e9, 7600.0)]):
        g[:, m + 1] = jmats.generate_group_vel_curve(*c)
        p[:, m + 1] = jmats.generate_phase_vel_curve(*c)
    veln = rng.uniform(0, 180, (Z, X))
    velpn = rng.integers(1, 3, (Z, X))
    vel_map = rng.uniform(0.8, 1.2, (Z, X))
    return (veln, velpn, vel_map, None, g, p)


CASES = {"weld": _weld_inputs, "tables": _table_inputs}


def _both(name):
    args = CASES[name]()
    jm = jgrid.make_model(*args, 2e-4, dtype=jnp.float64)
    tm = tgrid.make_model(*args, 2e-4, dtype=torch.float64, device="cpu")
    return jm, tm


def _fields(jm):
    out = {}
    for name in tgrid.TENSOR_FIELDS:
        v = getattr(jm, name)
        out[name] = None if v is None else np.asarray(v)
    return out


def _assert_model_equal(jm, tm):
    for name in tgrid.TENSOR_FIELDS:
        want = getattr(jm, name)
        got = getattr(tm, name)
        assert (want is None) == (got is None), name
        if want is None:
            continue
        want = np.asarray(want)
        got = got.cpu().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=name)
    assert tm.has_stif == jm.has_stif
    for info in ("phase_info", "group_info", "ray_info", "skew_info"):
        assert getattr(tm, info) == getattr(jm, info), info


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_model_matches_jax(case):
    jm, tm = _both(case)
    _assert_model_equal(jm, tm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_from_numpy_carries_jax_model(case):
    jm, _ = _both(case)
    tm = tgrid.model_from_numpy(
        _fields(jm), jm.has_stif, jm.phase_info, jm.group_info, jm.ray_info,
        device="cpu", dtype=torch.float64, skew_info=jm.skew_info)
    _assert_model_equal(jm, tm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_velocity_dispatch_matches_jax(case):
    jm, tm = _both(case)
    eff = np.random.default_rng(2).uniform(-200, 400, jm.shape)
    for jfn, tfn in ((jgrid.phase_velocity_at, tgrid.phase_velocity_at),
                     (jgrid.group_velocity_at, tgrid.group_velocity_at)):
        want = np.asarray(jfn(jm, jnp.asarray(eff)))
        got = tfn(tm, torch.from_numpy(eff)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _build_default(entry):
    args = _weld_inputs()
    if entry == "make_model":
        return tgrid.make_model(*args, 2e-4)
    tm = tgrid.make_model(*args, 2e-4, device="cpu")
    fields = {name: (None if getattr(tm, name) is None
                     else getattr(tm, name).numpy())
              for name in tgrid.TENSOR_FIELDS}
    return tgrid.model_from_numpy(fields, tm.has_stif, tm.phase_info,
                                  tm.group_info, tm.ray_info,
                                  skew_info=tm.skew_info)


@pytest.mark.parametrize("entry", ["make_model", "model_from_numpy"])
def test_default_device_is_the_card(entry):
    """With no ``device`` a model is built on the CUDA card; a host without
    one raises instead of building on the CPU."""
    if torch.cuda.is_available():
        assert _build_default(entry).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _build_default(entry)


def test_explicit_cpu_device_builds_on_the_cpu():
    tm = tgrid.make_model(*_weld_inputs(), 2e-4, device="cpu")
    assert tm.device.type == "cpu"
    assert tgrid.resolve_device("cpu") == torch.device("cpu")


def test_fallback_planes_on_patches_match_jax():
    """The device-side fallback slowness (rebuilt for every patch) against
    the JAX jitted version, on refined int32-truncated orientations."""
    jm, tm = _both("weld")
    veln = np.asarray(jgrid.refine_nearest(jm.veln, 3, jnp.int32)).astype(float)
    velpn = np.asarray(jgrid.refine_nearest(jm.velpn, 3))
    vmap = np.asarray(jgrid.refine_nearest(jm.vel_map, 3))
    stif = np.asarray(jgrid.refine_nearest_3d(jm.stif, 3))
    want = np.asarray(jgrid._fallback_slowness_planes(
        jnp.asarray(veln), jnp.asarray(velpn), jnp.asarray(vmap),
        jnp.asarray(stif), jm.group_tab, True))
    got = tgrid._fallback_slowness_planes(
        tgrid.refine_nearest(tm.veln, 3, torch.int32).double(),
        tgrid.refine_nearest(tm.velpn, 3), tgrid.refine_nearest(tm.vel_map, 3),
        tgrid.refine_nearest_3d(tm.stif, 3), tm.group_tab, True).numpy()
    np.testing.assert_array_equal(veln, tgrid.refine_nearest(
        tm.veln, 3, torch.int32).numpy())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_weld_data_layout():
    """The seeded weld has the reference workload's make-up: 424 x 500,
    parent 5790 m/s table material, a weld of about 61 % of the grid in 9
    integer orientation domains on the stiffness row, 31 + 31 transducers
    and 961 top -> bottom pairs."""
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0)
    assert veln.shape == velpn.shape == vel_map.shape == weld_data.SHAPE
    weld = velpn == 0
    assert abs(weld.mean() - 0.61) < 0.01
    np.testing.assert_array_equal(vel_map, np.where(weld, 1.0, 5790.0))
    np.testing.assert_array_equal(veln[~weld], 0.0)
    domains = np.unique(veln[weld])
    assert len(domains) == 9
    assert np.all((domains >= 0) & (domains < 180) & (domains % 1 == 0))
    np.testing.assert_array_equal(stif, np.load(weld_data._STIF_FILE))
    sx, sy, pairs = weld_data.transducers()
    assert sx.shape == (62,) and pairs.sum() == 961
    scx, scz, src_xy, rec_xy, tidx = weld_data.ray_pairs(sx, sy, pairs)
    assert scx.shape == (31,) and np.all(scz == weld_data.DNX * 423)
    assert src_xy.shape == rec_xy.shape == (961, 2) and tidx.max() == 30


@pytest.mark.parametrize("n, kinds", [(1, 1), (500, 7), (4000, 1), (4000, 60)])
def test_unique_rows_matches_numpy_unique(n, kinds):
    """grid._unique_rows (the lexsort behind the ray curve tables) gives
    np.unique(axis=0)'s rows and inverse, signed zeros included."""
    rng = np.random.default_rng(n + kinds)
    base = rng.integers(0, 4, (kinds, 5)).astype(float) * 1000.0
    base[0, 0] = -0.0
    rows = base[rng.integers(0, kinds, n)]
    want_rows, want_inv = np.unique(rows, axis=0, return_inverse=True)
    got_rows, got_inv = tgrid._unique_rows(rows)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_inv, np.reshape(want_inv, -1))
