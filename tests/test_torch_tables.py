"""PyTorch port, host-side tables: build_tables, the two curve
generators and min_max_vel against the JAX package, on the same numpy
inputs (float64).  Tolerance 1e-12 relative: the same float64 formulas,
numpy on both sides for the tables."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu.utils import validate as jvalidate
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import materials as tmats
from alifmm_tpu_torch import weld_data
from alifmm_tpu_torch.utils import validate as tvalidate

RTOL = 1e-12
# (c22, c23, c33, c44) in Pa and density: austenitic weld metal, a
# ferritic steel, a strongly anisotropic made-up row
MATERIALS = np.array([
    [263.0e9, 148.0e9, 216.0e9, 129.0e9, 8100.0],
    [281.0e9, 113.0e9, 281.0e9, 84.0e9, 7850.0],
    [120.0e9, 60.0e9, 300.0e9, 40.0e9, 5000.0],
    [200.0e9, 90.0e9, 230.0e9, 70.0e9, 7000.0],
    [150.0e9, 70.0e9, 170.0e9, 50.0e9, 2700.0],
])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("row", range(len(MATERIALS)))
def test_velocity_curves_match_jax(row):
    mat = MATERIALS[row]
    g = tmats.generate_group_vel_curve(*mat)
    p = tmats.generate_phase_vel_curve(*mat)
    assert g.shape == p.shape == (361,) and g.dtype == np.float64
    _close(g, jmats.generate_group_vel_curve(*mat))
    _close(p, jmats.generate_phase_vel_curve(*mat))
    assert np.all(g[180:] == g[:181]) and np.all(g > 0)


@pytest.mark.parametrize("materials", [MATERIALS, MATERIALS[0]],
                         ids=["square", "one row"])
def test_build_tables_fresh_matches_jax(materials):
    g, p, ids = tmats.build_tables(materials)
    wg, wp, wids = jmats.build_tables(materials)
    assert ids == wids and g.shape == wg.shape
    _close(g, wg)
    _close(p, wp)
    assert np.all(g[:, 0] == np.arange(361))


@pytest.mark.parametrize("materials", [MATERIALS[1:3], MATERIALS[4]],
                         ids=["two rows", "one row"])
def test_build_tables_keep_materials_matches_jax(materials):
    g0, p0, _ = jmats.build_tables(MATERIALS[0])
    g, p, ids = tmats.build_tables(materials, g0, p0, keep_materials=True)
    wg, wp, wids = jmats.build_tables(materials, g0, p0, keep_materials=True)
    assert ids == wids and g.shape == wg.shape
    _close(g, wg)
    _close(p, wp)
    np.testing.assert_array_equal(g[:, :2], g0)


def _models(stif_den, group_tab, phase_tab, velpn_weld):
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(3, (24, 28))
    velpn = np.where(velpn == 0, velpn_weld, velpn)
    if velpn_weld:
        vel_map = np.where(vel_map == 1.0, 1.0, 5790.0)
    stif = stif if stif_den else None
    args = (veln, velpn, vel_map, stif, group_tab, phase_tab, weld_data.DNX)
    return (jgrid.make_model(*args, dtype=jnp.float64),
            tgrid.make_model(*args, dtype=torch.float64, device="cpu"))


def test_min_max_vel_with_stiffness_matches_jax():
    jm, tm = _models(True, None, None, 0)
    got, want = tvalidate.min_max_vel(tm), jvalidate.min_max_vel(jm)
    _close(got, want)
    assert 1000 < got[0] < got[1] < 15000


def test_min_max_vel_tables_only_matches_jax():
    g, p, _ = tmats.build_tables(MATERIALS[:2], *tmats.default_tables(),
                                 keep_materials=True)
    jm, tm = _models(False, g, p, 2)
    got, want = tvalidate.min_max_vel(tm), jvalidate.min_max_vel(jm)
    _close(got, want)
    assert got[0] == g[:181, 2].min() and got[1] == g[:181, 2].max()
