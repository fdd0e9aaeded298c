"""PyTorch port, shear modes: the mode table builders of materials.py,
SolveConfig.accuracy() and for_mode(), solver.solve_one, the staged solve
and the facade on a qSV model, against the JAX package (float64, the port
on the CPU).

The qSV model is tests/test_qsv_mode.py's rough model shrunk to 17 x 19:
the first-arrival table pair of generate_mode_curves on every point (a
varying table column, K1's interpolated lookup).  Solves run one 3x patch
stage (``STAGES``, seed side 4) under ``for_mode("qsv")`` with the patch
and polish budgets cut, and ``final_polish_passes=1`` so that the
residual-driven polish of the batched solve (``final_max_polish`` 96)
differs from solve_one's fixed count.  One solve of each kind runs per
module; the facades reuse the staged one.  Tolerances: tables 1e-12
relative (the same numpy code), fields 1e-9 relative, ray times 1e-8
relative."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import alifmm_tpu
import alifmm_tpu_torch
from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu import solver as jsolver
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch import materials as tmats
from alifmm_tpu_torch import solver as tsolver
from alifmm_tpu_torch import weld_data
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL_TABLES = 1e-12
RTOL_FIELDS = 1e-9
RTOL_TIMES = 1e-8
# test_qsv_mode.py's austenite, in Pa; c66 differs from c44 for qSH
STIFF = (263e9, 145e9, 216e9, 129e9, 7800.0)
C66 = 98e9
SHAPE, DNX = (17, 19), 5e-4
STAGES = ((2, 3),)
SEED_SIDE = 4
CUT = dict(patch_max_passes=4, polish_passes=2, final_polish_passes=1)
# top transducers 0-1, bottom 2-3; rays top to bottom, whose receiver
# fields are the two staged sources
TRANS_X = np.array([4.0, 14.0, 5.0, 13.0])
TRANS_Z = np.array([0.0, 0.0, 16.0, 16.0])
PAIRS = np.zeros((4, 4))
PAIRS[:2, 2:] = 1
WELD_KNOBS = dict(max_cross=8, step_scale=9, plane_dist=5, quad_vel=3,
                  relax_iters=1, relax_quad=3, max_steps=20, cand_stride=7.0)


def _qsv_tables():
    g, p = jmats.generate_mode_curves(*STIFF, mode="qSV")
    return (np.stack([np.arange(361.0), g], axis=1),
            np.stack([np.arange(361.0), p], axis=1))


def _model_arrays():
    Z, X = SHAPE
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    veln = np.round((20.0 + 70.0 * np.sin(zz / 6.0) * np.cos(xx / 5.0))
                    % 180)
    return veln, np.ones((Z, X), dtype=int), np.ones((Z, X))


def _configs():
    return (jsolver.SolveConfig.for_mode("qsv", sweep_block=1,
                                         patch_block=1, **CUT),
            tsolver.SolveConfig.for_mode("qsv", **CUT))


# --------------------------------------------------------------------- #
# tables
# --------------------------------------------------------------------- #

def _close(got, want, rtol=RTOL_TABLES):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("mode", ["qP", "qSV", "qSH"])
def test_mode_tables_match_jax(mode):
    g, p = tmats.generate_mode_curves(*STIFF, c66=C66, mode=mode)
    wg, wp = jmats.generate_mode_curves(*STIFF, c66=C66, mode=mode)
    _close(g, wg)
    _close(p, wp)
    assert g.shape == p.shape == (361,)
    _close(tmats.first_arrival_group_curve(*STIFF, c66=C66, mode=mode),
           jmats.first_arrival_group_curve(*STIFF, c66=C66, mode=mode))
    # memoised, and handed out as copies
    g[:] = 0.0
    _close(tmats.generate_mode_curves(*STIFF, c66=C66, mode=mode)[0], wg)
    corners = tmats.wavefront_corner_angles(*STIFF, c66=C66, mode=mode)
    np.testing.assert_array_equal(
        corners, jmats.wavefront_corner_angles(*STIFF, c66=C66, mode=mode))
    assert len(corners) == {"qP": 0, "qSV": 4, "qSH": 0}[mode]
    # test_qsv_mode.py's duality check: the group table is the plane
    # envelope of the phase table and the phase table the support of the
    # group curve, to table resolution
    th = np.radians(np.arange(361.0))
    phi = np.linspace(0, 2 * np.pi, 7200, endpoint=False)
    p_dense = np.interp(np.degrees(phi) % 360, np.arange(361.0), wp,
                        period=360.0)
    g_from_p = tmats._radial_from_support(phi, p_dense, th)
    _close(g_from_p, jmats._radial_from_support(phi, p_dense, th))
    assert np.abs(g_from_p - wg).max() / wg.max() < 2e-3
    g_dense = np.interp(np.degrees(phi) % 360, np.arange(361.0), wg,
                        period=360.0)
    p_from_g = tmats._support_from_radial(phi, g_dense, th)
    _close(p_from_g, jmats._support_from_radial(phi, g_dense, th))
    assert np.abs(p_from_g - wp).max() / wp.max() < 2e-3


def test_slowness_derivative_matches_jax():
    # on an axis (within 0.01 degrees) first, then off it
    ang = np.array([0.0, 90.0, 180.0, 0.005, 89.995, 179.999, 45.0, 90.02,
                    0.02, 30.0, 44.999, 135.0, 200.0, -10.0, 359.5])
    stif = (263000.0, 148000.0, 216000.0, 129000.0, 8100.0)
    got = tmats.slowness_derivative(torch.from_numpy(ang), *stif).numpy()
    want = np.asarray(jmats.slowness_derivative(jnp.asarray(ang), *stif))
    assert got.dtype == np.float64
    _close(got, want)
    assert np.all(got[:6] == 0.0) and np.all(got[6:] != 0.0)
    # per-point stiffness and a velocity scale broadcast like JAX's.  The
    # difference of two slownesses 0.01 degrees apart cancels all but a
    # few digits, so an ulp of a group velocity (libm's tan or atan in
    # XLA against PyTorch's) moves the derivative by up to an ulp of the
    # slowness over the step: held to 4 such ulps
    c22 = np.linspace(250000.0, 270000.0, ang.size)
    got = tmats.slowness_derivative(ang, torch.from_numpy(c22), *stif[1:],
                                    vel_scale=0.5).numpy()
    want = np.asarray(jmats.slowness_derivative(
        jnp.asarray(ang), jnp.asarray(c22), *stif[1:], vel_scale=0.5))
    slowness = 1.0 / np.asarray(jmats.group_velocity_christoffel(
        jnp.asarray(ang), jnp.asarray(c22), *stif[1:], 0.5))
    ulps = 4 * np.finfo(np.float64).eps * slowness / 0.01
    assert np.all(np.abs(got - want) <= ulps)
    assert np.all((got == 0.0) == (want == 0.0))


# --------------------------------------------------------------------- #
# presets
# --------------------------------------------------------------------- #

SHARED_FIELDS = [f.name for f in dataclasses.fields(tsolver.SolveConfig)]


def _same_config(t, j):
    for name in SHARED_FIELDS:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("overrides", [{}, dict(rel_tol=5e-4,
                                                final_max_passes=40,
                                                stage3_half=19)])
def test_presets_match_jax(overrides):
    assert set(SHARED_FIELDS) <= {f.name for f in
                                  dataclasses.fields(jsolver.SolveConfig)}
    _same_config(tsolver.SolveConfig.accuracy(**overrides),
                 jsolver.SolveConfig.accuracy(**overrides))
    for mode in ("qp", "p", "l", "QP", "qsv", "qsh", "sv", "sh", "s", "t",
                 "qSV", "SH", "T"):
        got = tsolver.SolveConfig.for_mode(mode, **overrides)
        _same_config(got, jsolver.SolveConfig.for_mode(mode, **overrides))
        if not overrides:
            shear = mode.lower() not in ("qp", "p", "l")
            assert got.final_max_passes == (96 if shear else 16)
    _same_config(tsolver.SolveConfig.for_mode(),
                 jsolver.SolveConfig.for_mode())


def test_preset_errors():
    """An unknown mode raises ValueError and an unknown field TypeError in
    both packages; the multigrid fields, which the port refused with
    TypeError before it ported the multigrid start, override the presets
    as in the JAX package."""
    for cls in (tsolver.SolveConfig, jsolver.SolveConfig):
        with pytest.raises(ValueError, match="unknown wave mode 'qx'"):
            cls.for_mode("qx")
        with pytest.raises(TypeError):
            cls.accuracy(no_such_field=1)
    for kw in (dict(multigrid=True), dict(mg_passes=4), dict(mg_polish=1)):
        _same_config(tsolver.SolveConfig.for_mode("qsv", **kw),
                     jsolver.SolveConfig.for_mode("qsv", **kw))
        _same_config(tsolver.SolveConfig.accuracy(**kw),
                     jsolver.SolveConfig.accuracy(**kw))


# --------------------------------------------------------------------- #
# solves: one of each kind per module
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def qsv():
    """Both packages' qSV models, solve_one for source 0 and the staged
    solve of the two receivers (with its SolveInfo)."""
    gtab, ptab = _qsv_tables()
    veln, velpn, vel_map = _model_arrays()
    args = (veln, velpn, vel_map, None, gtab, ptab, DNX)
    jm = jgrid.make_model(*args, dtype=jnp.float64)
    tm = tgrid.make_model(*args, dtype=torch.float64, device="cpu")
    jcfg, tcfg = _configs()
    scx, scz = TRANS_X[2:] * DNX, TRANS_Z[2:] * DNX
    out = dict(jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg, scx=scx, scz=scz,
               tables=(gtab, ptab), arrays=(veln, velpn, vel_map))
    out["j_one"] = np.asarray(jsolver.solve_one(
        jm, scx[0], scz[0], STAGES, SEED_SIDE, -1.0, jcfg))
    out["t_one"] = tsolver.solve_one(tm, scx[0], scz[0], STAGES, SEED_SIDE,
                                     -1.0, tcfg)
    j, jinfo = jsolver._staged_solve(jm, jnp.asarray(scx), jnp.asarray(scz),
                                     STAGES, SEED_SIDE, -1.0, jcfg,
                                     return_info=True)
    out["j_staged"], out["j_info"] = np.asarray(j), jinfo
    out["t_staged"], out["t_info"] = tsolver._staged_solve(
        tm, scx, scz, STAGES, SEED_SIDE, -1.0, tcfg, return_info=True)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_solve_one_matches_jax(qsv):
    got, want = qsv["t_one"], qsv["j_one"]
    assert got.shape == SHAPE and got.dtype == torch.float64
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL_FIELDS, atol=0)
    # solve_one runs exactly final_polish_passes polish rounds where the
    # batched solve runs its residual-driven polish (final_max_polish):
    # the fields differ, in both packages alike
    j_gap = qsv["j_staged"][0] - want
    t_gap = qsv["t_staged"][0].numpy() - got
    assert _rel(qsv["j_staged"][0], want) > 1e-2
    np.testing.assert_allclose(t_gap, j_gap, rtol=0,
                               atol=RTOL_FIELDS * np.abs(want).max())


def test_solve_one_is_the_fixed_polish_staged_solve(qsv):
    """What solve_one ignores: with final_max_polish unset, the batched
    solve of the one source gives solve_one's field bit for bit."""
    cfg = dataclasses.replace(qsv["tcfg"], final_max_polish=None)
    one = tsolver._staged_solve(qsv["tm"], qsv["scx"][:1], qsv["scz"][:1],
                                STAGES, SEED_SIDE, -1.0, cfg)
    assert torch.equal(one[0], qsv["t_one"])


def test_staged_solve_with_info_matches_jax(qsv):
    got, info = qsv["t_staged"], qsv["t_info"]
    want, winfo = qsv["j_staged"], qsv["j_info"]
    assert got.shape == (2,) + SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_FIELDS, atol=0)
    assert info.passes == int(winfo.passes)
    assert info.converged == bool(winfo.converged)
    assert info.converged and info.passes < 96


@pytest.fixture
def facades(qsv, monkeypatch):
    """Both facades on the qSV tables with the cut stage schedule; the
    port's reuses the staged solve of ``qsv`` (the same model, receivers
    and budget, held against JAX above)."""
    for mod in (jsolver, tsolver):
        monkeypatch.setattr(mod, "_COARSE_STAGES", STAGES)
        monkeypatch.setattr(mod, "_COARSE_SEED_SIDE", SEED_SIDE)
    monkeypatch.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
    monkeypatch.setattr(alifmm_tpu_torch, "tqdm_disable", True)
    solve = alifmm_tpu_torch.ALI_FMM._solve_fields

    def shared(self, model, scx, scz, subgrid_size, progress=None):
        same = (np.array_equal(scx, qsv["scx"])
                and np.array_equal(scz, qsv["scz"]) and subgrid_size == 1
                and self._cfg == qsv["tcfg"]
                and all(torch.equal(getattr(model, n), getattr(qsv["tm"], n))
                        for n in ("veln", "velpn", "vel_map", "phase_tab",
                                  "group_tab", "fallback_slowness")))
        if same:
            return qsv["t_staged"].clone()
        return solve(self, model, scx, scz, subgrid_size, progress)

    monkeypatch.setattr(alifmm_tpu_torch.ALI_FMM, "_solve_fields", shared)
    gtab, ptab = qsv["tables"]
    veln, velpn, vel_map = qsv["arrays"]
    sx, sy = TRANS_X * DNX, TRANS_Z * DNX
    kw = dict(group_vel=gtab, phase_vel=ptab, dnx=DNX, ray_opts=WELD_KNOBS)
    jf = alifmm_tpu.ALI_FMM(veln, velpn, vel_map, sx, sy,
                            dtype=jnp.float64, solve_opts=qsv["jcfg"], **kw)
    tf = alifmm_tpu_torch.ALI_FMM(veln, velpn, vel_map, sx, sy,
                                  dtype=torch.float64, device="cpu",
                                  solve_opts=qsv["tcfg"], **kw)
    return jf, tf, (veln, velpn, vel_map)


def test_facade_qsv_rays_match_jax(facades):
    jf, tf, arrays = facades
    kw = dict(subgrid_size=weld_data.SUBGRID, trans_pairs=PAIRS,
              n_threads=2)
    want = jf.find_all_TTF_rays_parallel(*arrays, **kw)
    got = tf.find_all_TTF_rays_parallel(*arrays, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL_TIMES, atol=0)
    traced = PAIRS == 1
    assert np.all(got[traced] > 0) and np.all(got[~traced] == 0)
    np.testing.assert_array_equal(tf.ray_len, jf.ray_len)
    # qSV speeds lie in the table's 2.3-3.2 km/s: no ray beats the
    # straight line at the fastest speed
    d = np.hypot(TRANS_X[2:][None] - TRANS_X[:2][:, None],
                 TRANS_Z[2:][None] - TRANS_Z[:2][:, None]) * DNX
    assert np.all(got[:2, 2:] >= d / jf.velocity_dat[:, 1].max())
