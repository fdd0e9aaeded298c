"""PyTorch port, shear modes: the mode table builders of materials.py,
SolveConfig.accuracy() and for_mode(), solver.solve_one, the staged solve
and the facade on a qSV model, and qSH staged solves (the same model with
the qSH pair, and a homogeneous qSH model against its closed-form first
arrival), against the JAX package (float64, the port on the CPU).

The qSV model is tests/test_qsv_mode.py's rough model shrunk to 17 x 19:
the first-arrival table pair of generate_mode_curves on every point (a
varying table column, K1's interpolated lookup).  Solves run one 3x patch
stage (``STAGES``, seed side 4) under ``for_mode("qsv")`` with the patch
and polish budgets cut, and ``final_polish_passes=1`` so that the
residual-driven polish of the batched solve (``final_max_polish`` 96)
differs from solve_one's fixed count.  One solve of each kind runs per
module; the facades reuse the staged one.  The qSH solves keep the
model's shape, the two sources and the budget under for_mode("qsh"),
which equals for_mode("qsv"), so that JAX runs them on the qSV solve's
compiled programs.  JAX's solves run in a second process
(tests/_jax_side.py), one after another, while the port runs.
Tolerances: tables 1e-12 relative (the same numpy code), fields 1e-9
relative, ray times 1e-8 relative; the homogeneous qSH field's error
against the closed-form time no larger than JAX's plus 1e-12."""

import functools

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
import _jax_side

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


# the homogeneous qSH model's sources (x, z in cells): interior points
HOMOG_SOURCES = np.array([[9.0, 8.0], [6.0, 11.0]])


def _qsv_tables(mode="qSV"):
    c66 = C66 if mode == "qSH" else None
    g, p = jmats.generate_mode_curves(*STIFF, c66=c66, mode=mode)
    return (np.stack([np.arange(361.0), g], axis=1),
            np.stack([np.arange(361.0), p], axis=1))


def _model_arrays(homogeneous=False):
    Z, X = SHAPE
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    veln = np.round((20.0 + 70.0 * np.sin(zz / 6.0) * np.cos(xx / 5.0))
                    % 180)
    if homogeneous:
        veln = np.zeros((Z, X))
    return veln, np.ones((Z, X), dtype=int), np.ones((Z, X))


def _configs(mode="qsv"):
    return (jsolver.SolveConfig.for_mode(mode, sweep_block=1,
                                         patch_block=1, **CUT),
            tsolver.SolveConfig.for_mode(mode, **CUT))


# the solves: (table mode, homogeneous orientation) of each model, and its
# sources (x, z in metres)
SOLVES = {"qsv": ("qSV", False), "qsh": ("qSH", False),
          "qsh homogeneous": ("qSH", True)}


def _sources(name):
    if SOLVES[name][1]:
        return HOMOG_SOURCES[:, 0] * DNX, HOMOG_SOURCES[:, 1] * DNX
    return TRANS_X[2:] * DNX, TRANS_Z[2:] * DNX


def _model_args(name):
    mode, homogeneous = SOLVES[name]
    return (*_model_arrays(homogeneous), None, *_qsv_tables(mode), DNX)


def _jax_solve(name, one=False):
    """JAX's staged solve of ``name``'s model and sources under its
    mode's preset, (field, passes, converged); ``one``: solve_one of the
    first source, the field."""
    jm = jgrid.make_model(*_model_args(name), dtype=jnp.float64)
    jcfg = _configs(SOLVES[name][0].lower())[0]
    scx, scz = _sources(name)
    if one:
        return np.asarray(jsolver.solve_one(jm, scx[0], scz[0], STAGES,
                                            SEED_SIDE, -1.0, jcfg))
    j, info = jsolver._staged_solve(jm, jnp.asarray(scx), jnp.asarray(scz),
                                    STAGES, SEED_SIDE, -1.0, jcfg,
                                    return_info=True)
    return np.asarray(j), int(info.passes), bool(info.converged)


def _qsh_time(scx, scz):
    """The closed-form qSH first arrival on the homogeneous model
    (orientation 0): t = sqrt((x / v0)^2 + (z / v90)^2), v0 = sqrt(c66 /
    rho) along x, v90 = sqrt(c44 / rho) along z."""
    c44, rho = STIFF[3], STIFF[4]
    v0, v90 = np.sqrt(C66 / rho), np.sqrt(c44 / rho)
    zz, xx = np.meshgrid(np.arange(SHAPE[0]) * DNX,
                         np.arange(SHAPE[1]) * DNX, indexing="ij")
    return np.stack([np.hypot((xx - x) / v0, (zz - z) / v90)
                     for x, z in zip(scx, scz)])


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
def jax_refs():
    """The module's JAX solves, in the order the tests take them,
    computed in a second process while the port runs."""
    jobs = {"one": functools.partial(_jax_solve, "qsv", one=True)}
    jobs.update({name: functools.partial(_jax_solve, name)
                 for name in SOLVES})
    jobs["facade"] = _jax_facade
    with _jax_side.references(jobs) as refs:
        yield refs


@pytest.fixture(scope="module")
def qsv(jax_refs):
    """The qSV model (the port's), solve_one for source 0 and the staged
    solve of the two receivers (with its SolveInfo) in the port, and
    JAX's (``jax_refs``)."""
    tm = tgrid.make_model(*_model_args("qsv"), dtype=torch.float64,
                          device="cpu")
    tcfg = _configs()[1]
    scx, scz = _sources("qsv")
    out = dict(tm=tm, tcfg=tcfg, scx=scx, scz=scz, jax=jax_refs)
    out["t_one"] = tsolver.solve_one(tm, scx[0], scz[0], STAGES, SEED_SIDE,
                                     -1.0, tcfg)
    out["t_staged"], out["t_info"] = tsolver._staged_solve(
        tm, scx, scz, STAGES, SEED_SIDE, -1.0, tcfg, return_info=True)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_solve_one_matches_jax(qsv):
    got, want = qsv["t_one"], qsv["jax"]["one"].result()
    assert got.shape == SHAPE and got.dtype == torch.float64
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL_FIELDS, atol=0)
    # solve_one runs exactly final_polish_passes polish rounds where the
    # batched solve runs its residual-driven polish (final_max_polish):
    # the fields differ, in both packages alike
    j_staged = qsv["jax"]["qsv"].result()[0]
    j_gap = j_staged[0] - want
    t_gap = qsv["t_staged"][0].numpy() - got
    assert _rel(j_staged[0], want) > 1e-2
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
    want, passes, converged = qsv["jax"]["qsv"].result()
    assert got.shape == (2,) + SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_FIELDS, atol=0)
    assert info.passes == passes
    assert info.converged == converged
    assert info.converged and info.passes < 96


def _port_solve(name):
    tm = tgrid.make_model(*_model_args(name), dtype=torch.float64,
                          device="cpu")
    scx, scz = _sources(name)
    return tsolver._staged_solve(tm, scx, scz, STAGES, SEED_SIDE, -1.0,
                                 _configs("qsh")[1], return_info=True)


def test_qsh_staged_solve_matches_jax(qsv):
    """The qSV model with the qSH pair (c66 = 98e9) as its table column,
    the two receivers' staged solve under for_mode("qsh"): within 1e-9 of
    JAX with an equal SolveInfo; qSH's convex slowness converges in fewer
    passes than qSV's."""
    got, info = _port_solve("qsh")
    want, passes, converged = qsv["jax"]["qsh"].result()
    assert got.shape == (2,) + SHAPE
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_FIELDS, atol=0)
    assert (info.passes, info.converged) == (passes, converged)
    assert info.converged and info.passes < qsv["t_info"].passes


def test_qsh_homogeneous_matches_jax_and_closed_form(qsv):
    """Homogeneous qSH at orientation 0 (elliptical: the first arrival is
    closed-form), two interior sources: the port within 1e-9 of JAX, and
    its largest and mean relative error against the closed-form time over
    every point but the sources no larger than JAX's plus 1e-12."""
    got, info = _port_solve("qsh homogeneous")
    want, passes, converged = qsv["jax"]["qsh homogeneous"].result()
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_FIELDS, atol=0)
    assert (info.passes, info.converged) == (passes, converged)
    assert info.converged
    t = _qsh_time(*_sources("qsh homogeneous"))
    mask = t > 0
    errs = [np.abs(f - t)[mask] / t[mask] for f in (got, want)]
    assert errs[0].max() <= errs[1].max() + 1e-12
    assert errs[0].mean() <= errs[1].mean() + 1e-12


FACADE_KW = dict(subgrid_size=weld_data.SUBGRID, trans_pairs=PAIRS,
                 n_threads=2)


def _facade_args():
    gtab, ptab = _qsv_tables()
    return (*_model_arrays(), TRANS_X * DNX, TRANS_Z * DNX), dict(
        group_vel=gtab, phase_vel=ptab, dnx=DNX, ray_opts=WELD_KNOBS)


def _jax_facade():
    """The JAX facade's find_all_TTF_rays_parallel on the qSV tables with
    the cut stage schedule: (time matrix, ray lengths, the table's largest
    velocity)."""
    args, kw = _facade_args()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolver, "_COARSE_STAGES", STAGES)
        mp.setattr(jsolver, "_COARSE_SEED_SIDE", SEED_SIDE)
        mp.setattr(alifmm_tpu, "tqdm_disable", True, raising=False)
        jf = alifmm_tpu.ALI_FMM(*args, dtype=jnp.float64,
                                solve_opts=_configs()[0], **kw)
        times = jf.find_all_TTF_rays_parallel(*args[:3], **FACADE_KW)
        return times, jf.ray_len, float(jf.velocity_dat[:, 1].max())


@pytest.fixture
def facades(qsv, monkeypatch):
    """The port's facade on the qSV tables with the cut stage schedule; it
    reuses the staged solve of ``qsv`` (the same model, receivers and
    budget, held against JAX above)."""
    monkeypatch.setattr(tsolver, "_COARSE_STAGES", STAGES)
    monkeypatch.setattr(tsolver, "_COARSE_SEED_SIDE", SEED_SIDE)
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
    args, kw = _facade_args()
    tf = alifmm_tpu_torch.ALI_FMM(*args, dtype=torch.float64, device="cpu",
                                  solve_opts=qsv["tcfg"], **kw)
    return qsv["jax"]["facade"], tf, args[:3]


def test_facade_qsv_rays_match_jax(facades):
    jax_facade, tf, arrays = facades
    got = tf.find_all_TTF_rays_parallel(*arrays, **FACADE_KW)
    want, ray_len, vmax = jax_facade.result()
    np.testing.assert_allclose(got, want, rtol=RTOL_TIMES, atol=0)
    traced = PAIRS == 1
    assert np.all(got[traced] > 0) and np.all(got[~traced] == 0)
    np.testing.assert_array_equal(tf.ray_len, ray_len)
    # qSV speeds lie in the table's 2.3-3.2 km/s: no ray beats the
    # straight line at the fastest speed
    d = np.hypot(TRANS_X[2:][None] - TRANS_X[:2][:, None],
                 TRANS_Z[2:][None] - TRANS_Z[:2][:, None]) * DNX
    assert np.all(got[:2, 2:] >= d / vmax)
