"""PyTorch port, sweeps: the plain twin of the sweep kernel (ops/sweep.py)
against the JAX XLA sweep (float64) and against the Pallas sweep kernel
run in interpret mode (float32), on the 20 x 26 model of
tests/test_pallas_sweep.py with three seeded sources, and on a version of
it whose table column varies with the angle (qSV tables).  JAX's
fixpoints and the Pallas run go to a second process (tests/_jax_side.py),
started with the module's fixture, while the port runs."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alifmm_tpu import grid as jgrid
from alifmm_tpu import materials as jmats
from alifmm_tpu.ops import pallas_sweep
from alifmm_tpu.ops import stencils as jst
from alifmm_tpu.ops import sweep as jsweep
from alifmm_tpu_torch import grid as tgrid
from alifmm_tpu_torch.ops import cuda_sweep
from alifmm_tpu_torch.ops import sweep as tsweep
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _jax_side

RTOL_F64 = 1e-9   # same operations in float64: ulps, no tie flips
RTOL_PALLAS = 1e-4  # the kernel's folded-coefficient velocity and
                    # polynomial arctan differ by up to 2e-5 in float32
RTOL_TABLE = 1e-10  # one pass through the interpolated lookup


def _jax_model(dtype):
    Z, X = 20, 26
    rng = np.random.default_rng(3)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.ones((Z, X), dtype=int)
    velpn[5:15, 7:19] = 0
    vel_map = np.where(velpn == 1, 5790.0, 1.0).astype(np.float32)
    stif = np.zeros((Z, X, 5), dtype=np.int64)
    stif[:, :] = [263000, 148000, 216000, 129000, 8100]
    return jgrid.make_model(veln, velpn, vel_map, stif, None, None, 2e-4,
                            dtype=dtype)


def _torch_model(jm, dtype):
    fields = {n: (None if getattr(jm, n) is None else np.asarray(getattr(jm, n)))
              for n in tgrid.TENSOR_FIELDS}
    return tgrid.model_from_numpy(fields, jm.has_stif, jm.phase_info,
                                  jm.group_info, jm.ray_info, device="cpu",
                                  dtype=dtype)


def _seeded(shape, dtype, B=3):
    Z, X = shape
    tt0 = np.full((B, Z, X), jst.INF, dtype)
    fixed = np.zeros((B, Z, X), bool)
    for b in range(B):
        sz, sx = 9 + b, 13 - 2 * b
        tt0[b, sz, sx] = 0.0
        fixed[b, sz, sx] = True
        tt0[b, sz, sx + 1] = 4e-8
        fixed[b, sz, sx + 1] = True
    return tt0, fixed


# solve_fixpoint's budgets: the joint fixpoint, and the forms' fixpoints
FIXPOINT = dict(rel_tol=1e-4, max_passes=8, polish_passes=3)
FORM_BUDGET = dict(rel_tol=1e-4, max_passes=4, polish_passes=2)
FORMS = [dict(inner=2), dict(phase1_use_ali=False), dict(polish_use_fd=False),
         dict(use_ali=False)]


def _jax_fixpoint(form=None):
    """JAX's solve_fixpoint on the float64 model's seeds: the joint
    fixpoint (``form`` None) or the FORM_BUDGET fixpoint with ``form``'s
    keywords; (field, passes, converged)."""
    jm = _jax_model(jnp.float64)
    tt0, fixed = _seeded(jm.shape, np.float64)
    kw = FIXPOINT if form is None else dict(FORM_BUDGET, **form)
    want, info = jsweep.solve_fixpoint(jnp.asarray(tt0), jm,
                                       jnp.asarray(fixed), **kw)
    return np.asarray(want), int(info.passes), bool(info.converged)


def _jax_pallas():
    """The Pallas kernel's fixpoint (interpret mode, float32) on the seeds,
    as tests/test_pallas_sweep.py runs it."""
    pallas_sweep.INTERPRET = True
    jm = _jax_model(jnp.float32)
    tt0, fixed = _seeded(jm.shape, np.float32)
    want, _ = pallas_sweep.solve_fixpoint_pallas(
        jnp.asarray(tt0), jm, jnp.asarray(fixed), rel_tol=1e-4, max_passes=8,
        polish_passes=3, batch_chunk=2,
    )
    return np.asarray(want)


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX fixpoints, in the order the tests take them."""
    jobs = {"fixpoint": _jax_fixpoint}
    jobs.update({f"form {k}": functools.partial(_jax_fixpoint, form)
                 for k, form in enumerate(FORMS)})
    jobs["pallas"] = _jax_pallas
    with _jax_side.references(jobs) as refs:
        yield refs


@pytest.fixture(scope="module")
def f64(jax_refs):
    jm = _jax_model(jnp.float64)
    tm = _torch_model(jm, torch.float64)
    tt0, fixed = _seeded(jm.shape, np.float64)
    return jm, tm, tt0, fixed


def _assert_close(got, want, fixed, rtol):
    mask = ~fixed
    np.testing.assert_array_equal(got >= jst.INF * 0.5, want >= jst.INF * 0.5)
    known = mask & (want < jst.INF * 0.5)
    rel = np.abs(got - want)[known] / np.maximum(want[known], 1e-12)
    assert rel.max() < rtol, rel.max()


def test_gs_pass_min_and_replace_match_jax(f64):
    jm, tm, tt0, fixed = f64
    jpass = jax.jit(jsweep.gs_pass)
    # phase-1 pass from the seeded field, then a replace pass on a field
    # two min passes in (where the replace rule actually changes values)
    want1 = np.asarray(jpass(jnp.asarray(tt0), jm, jnp.asarray(fixed), False))
    got1 = tsweep.gs_pass(torch.from_numpy(tt0), tm, torch.from_numpy(fixed),
                          replace=False).numpy()
    _assert_close(got1, want1, fixed, RTOL_F64)
    mid = np.asarray(jpass(jnp.asarray(want1), jm, jnp.asarray(fixed), False))
    want2 = np.asarray(jpass(jnp.asarray(mid), jm, jnp.asarray(fixed), True))
    got2 = tsweep.gs_pass(torch.from_numpy(mid.copy()), tm, torch.from_numpy(fixed),
                          replace=True).numpy()
    _assert_close(got2, want2, fixed, RTOL_F64)
    assert np.any(want2 != mid)


@pytest.mark.parametrize("solve", ["plain", "pass_loop"])
def test_solve_fixpoint_matches_jax(f64, jax_refs, solve):
    """Joint two-phase fixpoint: the plain solve_fixpoint, and the pass
    loop the solver calls (which takes the plain twin on CPU tensors)."""
    jm, tm, tt0, fixed = f64
    fn = tsweep.solve_fixpoint if solve == "plain" else cuda_sweep.solve_fixpoint
    got, info = fn(torch.from_numpy(tt0), tm, torch.from_numpy(fixed),
                   **FIXPOINT)
    want, passes, converged = jax_refs["fixpoint"].result()
    _assert_close(got.numpy(), want, fixed, RTOL_F64)
    assert info.passes == passes
    assert info.converged == converged


def _qsv_table_model():
    """The 20 x 26 layout with every phase-velocity path of the sweep:
    column 2 a constant table column (vel_map 3240 m/s), column 1 the qSV
    first-arrival pair of generate_mode_curves, interpolated by angle, and
    a stiffness block (velpn 0, the Christoffel solve)."""
    Z, X = 20, 26
    rng = np.random.default_rng(4)
    g, p = jmats.generate_mode_curves(263e9, 148e9, 216e9, 129e9, 8100.0,
                                      mode="qSV")
    gtab = np.stack([np.arange(361.0), g, np.ones(361)], axis=1)
    ptab = np.stack([np.arange(361.0), p, np.ones(361)], axis=1)
    veln = np.round(rng.uniform(0, 180, (Z, X)))
    velpn = np.full((Z, X), 2)
    velpn[3:17, 4:22] = 1
    velpn[8:12, 10:16] = 0
    vel_map = np.where(velpn == 2, 3240.0, 1.0)
    stif = np.zeros((Z, X, 5), dtype=np.int64)
    stif[:, :] = [263000, 148000, 216000, 129000, 8100]
    jm = jgrid.make_model(veln, velpn, vel_map, stif, gtab, ptab, 2e-4,
                          dtype=jnp.float64)
    return jm, _torch_model(jm, torch.float64)


def test_gs_pass_varying_table_column_matches_jax():
    """A min pass and a replace pass where the ALI update interpolates a
    varying table column (K1's column mode 2)."""
    jm, tm = _qsv_table_model()
    assert [c is None for _, c in tm.phase_info] == [True, False]
    tt0, fixed = _seeded(jm.shape, np.float64)
    jpass = jax.jit(jsweep.gs_pass)
    t = torch.from_numpy
    want1 = np.asarray(jpass(jnp.asarray(tt0), jm, jnp.asarray(fixed), False))
    got1 = tsweep.gs_pass(t(tt0), tm, t(fixed), replace=False).numpy()
    _assert_close(got1, want1, fixed, RTOL_TABLE)
    mid = np.asarray(jpass(jnp.asarray(want1), jm, jnp.asarray(fixed), False))
    want2 = np.asarray(jpass(jnp.asarray(mid), jm, jnp.asarray(fixed), True))
    got2 = tsweep.gs_pass(t(mid.copy()), tm, t(fixed), replace=True).numpy()
    _assert_close(got2, want2, fixed, RTOL_TABLE)
    assert np.any(want2 != mid)


def test_isotropic_replace_pass_matches_jax():
    """An exactly symmetric isotropic seed (3000 m/s, dnx 1e-3, one source
    at (16, 20) of 32 x 40): four min passes, then a replace pass on JAX's
    four.  Its stencil choices tie to an ulp, so one ulp in a square root
    moves the replace pass by 1.6e-2: the twins' roots must be correctly
    rounded, as JAX's and CUDA's are (ops/_math.sqrt)."""
    Z, X = 32, 40
    jm = jgrid.make_model(np.zeros((Z, X)), np.ones((Z, X), dtype=int),
                          np.full((Z, X), 3000.0), None, None, None, 1e-3,
                          dtype=jnp.float64)
    tm = _torch_model(jm, torch.float64)
    tt0 = np.full((1, Z, X), jst.INF)
    fixed = np.zeros((1, Z, X), bool)
    tt0[0, 16, 20] = 0.0
    fixed[0, 16, 20] = True
    jpass = jax.jit(jsweep.gs_pass)
    t = torch.from_numpy
    want, got = tt0, t(tt0.copy())
    for _ in range(4):
        want = np.asarray(jpass(jnp.asarray(want), jm, jnp.asarray(fixed),
                                False))
        got = tsweep.gs_pass(got, tm, t(fixed), replace=False)
        _assert_close(got.numpy(), want, fixed, RTOL_F64)
    want2 = np.asarray(jpass(jnp.asarray(want), jm, jnp.asarray(fixed), True))
    got2 = tsweep.gs_pass(t(want.copy()), tm, t(fixed), replace=True).numpy()
    _assert_close(got2, want2, fixed, RTOL_F64)
    assert np.any(want2 != want)


@pytest.mark.parametrize("kw", FORMS)
def test_unported_forms_raise(f64, jax_refs, kw):
    """The fixpoint forms that raised NotImplementedError before they were
    ported now match the JAX package's, with equal SolveInfo: the
    two-loop form (inner > 0 with block 1, a differing phase-1 operator,
    the FD-free polish) and the FD-only operator in both phases."""
    jm, tm, tt0, fixed = f64
    t, f = torch.from_numpy(tt0), torch.from_numpy(fixed)
    got, info = tsweep.solve_fixpoint(t, tm, f, **FORM_BUDGET, **kw)
    want, passes, converged = jax_refs[f"form {FORMS.index(kw)}"].result()
    _assert_close(got.numpy(), want, fixed, RTOL_F64)
    assert info.passes == passes
    assert info.converged == converged


def test_graphed_pass_needs_cuda_fields(f64):
    """gs_pass(graphed=True) replays CUDA graphs; on CPU fields it raises
    and leaves the pass count alone (chip_smoke.py holds it to the eager
    pass on the card)."""
    jm, tm, tt0, fixed = f64
    calls = tsweep.CALLS
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.gs_pass(torch.from_numpy(tt0), tm, torch.from_numpy(fixed),
                       graphed=True)
    assert tsweep.CALLS == calls


def test_plain_twin_matches_pallas_kernel(jax_refs):
    """As tests/test_pallas_sweep.py runs the Pallas kernel (interpret
    mode, float32), against the port's plain twin on the same model."""
    jm = _jax_model(jnp.float32)
    tm = _torch_model(jm, torch.float32)
    tt0, fixed = _seeded(jm.shape, np.float32)
    got, _ = tsweep.solve_fixpoint(torch.from_numpy(tt0), tm,
                                   torch.from_numpy(fixed), **FIXPOINT)
    _assert_close(got.numpy(), jax_refs["pallas"].result(), fixed,
                  RTOL_PALLAS)


@pytest.mark.parametrize("shape,lanes", [((424, 500), 4), ((109, 109), 8),
                                         ((79, 79), 8)])
def test_k1_launch_config_fills_the_card(shape, lanes):
    """31 sources take clusters of 8 CTAs at every stage shape of the weld
    solve, 4 lanes per point at the wide final stage and 8 at the
    patches; tiles stay at least MIN_TILE wide."""
    assert cuda_sweep.launch_config(31, *shape, 132) == (8, lanes)
    assert cuda_sweep.launch_config(3, 5, 7, 132) == (1, 8)
    assert cuda_sweep.launch_config(3, 48, 56, 132) == (4, 8)
    assert cuda_sweep.launch_config(1, 64, 64, 132, 8, 4) == (8, 4)
    for bad in (dict(cluster=3), dict(cluster=16), dict(lanes=16)):
        with pytest.raises(ValueError):
            cuda_sweep.launch_config(31, *shape, 132, **bad)
    with pytest.raises(ValueError):
        cuda_sweep.launch_config(1, 10, 2000, 132, cluster=1)


def test_pack_model_transposed_planes(f64):
    """The x-sweeps' planes are the z-sweeps' planes transposed."""
    _, tm, _, _ = f64
    packed = cuda_sweep.pack_model(tm)
    assert packed.planes.shape[-3:] == (12,) + tm.shape
    torch.testing.assert_close(packed.planes_t,
                               packed.planes.transpose(-1, -2), rtol=0,
                               atol=0)
    assert packed.planes_t.is_contiguous()
