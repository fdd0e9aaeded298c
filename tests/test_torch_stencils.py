"""PyTorch port, local update: stencils.local_update (through
full_grid_update) point for point against the JAX package on random
partial travel-time fields, causal on and off, float64.  The full-grid
update covers interior and edge points alike."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu.ops import stencils as jst
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.ops import stencils as tst
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-10  # the same arithmetic in another framework: ulps, no tie flips


def _make_tables(rng, n_mats=2):
    """Anisotropic group/phase tables from random orthotropic stiffnesses
    (the generator of tests/test_local_update_parity.py)."""
    g = np.zeros((361, n_mats + 1))
    p = np.zeros((361, n_mats + 1))
    g[:, 0] = np.arange(361)
    p[:, 0] = np.arange(361)
    for m in range(n_mats):
        c22 = rng.uniform(200e9, 280e9)
        c33 = rng.uniform(200e9, 280e9)
        c44 = rng.uniform(80e9, 130e9)
        c23 = rng.uniform(100e9, min(c22, c33) * 0.7)
        rho = rng.uniform(7000, 8000)
        g[:, m + 1] = jmats.generate_group_vel_curve(c22, c23, c33, c44, rho)
        p[:, m + 1] = jmats.generate_phase_vel_curve(c22, c23, c33, c44, rho)
    return g, p


def _partial_field(rng, nnz, nnx, dnx, speed=5000.0):
    """Random partial field: ~60% known points with distance-like times
    (the generator of tests/test_local_update_parity.py)."""
    known = rng.random((nnz, nnx)) < 0.6
    zz, xx = np.meshgrid(np.arange(nnz), np.arange(nnx), indexing="ij")
    base = dnx * np.hypot(zz - nnz / 2, xx - nnx / 3) / speed
    ttn = np.where(known, base * rng.uniform(0.9, 1.1, (nnz, nnx)) + 1e-7, 0.0)
    return np.where(known, ttn, jst.INF)


def _table_case(seed):
    rng = np.random.default_rng(seed)
    nnz, nnx, dnx = 11, 13, 2e-4
    g_tab, p_tab = _make_tables(rng)
    veln = rng.uniform(0, 180, (nnz, nnx))
    velpn = rng.integers(1, 3, (nnz, nnx))
    vel_map = rng.uniform(0.8, 1.2, (nnz, nnx))
    tt = _partial_field(rng, nnz, nnx, dnx)
    return (veln, velpn, vel_map, None, g_tab, p_tab, dnx), tt


def _weld_case(seed):
    """Stiffness (Christoffel) cells beside isotropic table cells."""
    rng = np.random.default_rng(seed)
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(seed, (12, 16))
    dnx = 2e-4
    tt = _partial_field(rng, 12, 16, dnx, speed=5790.0)
    return (veln, velpn, vel_map, stif, None, None, dnx), tt


def _compare(args, tt, causal):
    jm = jgrid.make_model(*args, dtype=jnp.float64)
    tm = tgrid.make_model(*args, dtype=torch.float64, device="cpu")
    fixed = np.zeros(tt.shape, bool)
    want = np.asarray(jst.full_grid_update(jnp.asarray(tt), jm,
                                           jnp.asarray(fixed), causal=causal))
    got = tst.full_grid_update(torch.from_numpy(tt), tm,
                               torch.from_numpy(fixed), causal=causal).numpy()
    finite = want < jst.INF * 0.5
    np.testing.assert_array_equal(got < tst.INF * 0.5, finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=0)
    assert finite.sum() > tt.size // 2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_local_update_tables_matches_jax(seed, causal):
    args, tt = _table_case(seed)
    _compare(args, tt, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_local_update_weld_matches_jax(seed, causal):
    args, tt = _weld_case(seed)
    _compare(args, tt, causal)


def test_local_update_all_known():
    """Every neighbour known: the ALI square stencils dominate."""
    rng = np.random.default_rng(42)
    nnz, nnx, dnx = 9, 10, 1e-3
    g_tab, p_tab = _make_tables(rng, n_mats=1)
    veln = rng.uniform(0, 90, (nnz, nnx))
    zz, xx = np.meshgrid(np.arange(nnz), np.arange(nnx), indexing="ij")
    tt = dnx * np.hypot(zz - 4, xx - 5) / 3000.0 + 1e-8
    args = (veln, np.ones((nnz, nnx), int), np.ones((nnz, nnx)), None,
            g_tab, p_tab, dnx)
    _compare(args, tt, causal=False)
