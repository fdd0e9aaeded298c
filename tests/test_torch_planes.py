"""K6, the model build's fallback slowness planes (csrc/planes.cu, wrapper
ops/cuda_planes.fallback_planes), and make_model's choice of it.

The twin is the JAX package's numpy function
(alifmm_tpu.grid._np_fallback_slowness_planes), run in float64 on the
float64 casts of K6's inputs: K6's float32 planes lie within one float32
ulp of the twin rounded to float32 (only tan, atan, cos and sin come from
another library than numpy's), its float64 planes within 1e-12 relative.
The card's host has no JAX, so there the checks take the port's copy of
that function (chip_smoke.py's phase 16), which the CPU tests here hold to
the JAX package's bit for bit on every case, and compare make_model on the
card with golden/planes_jax.npz: the planes of the JAX package's
make_model on the same maps, which the CPU tests hold to be current.
Write it anew with ``python tests/test_torch_planes.py``.

On the card (``python -m pytest --noconftest tests/test_torch_planes.py``;
the card tests skip without one): K6 on seed 0's 424 x 500 weld, the table
case of test_torch_model.py and a mixed 48 x 56 case; make_model on the
card (one launch a build, the other fields equal to the host upload; the
planes against the JAX package's make_model; inputs in any memory order).

On any host: the wrapper's checks raise before anything is built or
launched, a CPU build keeps the numpy planes (no launch) and takes inputs
in any memory order, and the twin and golden file are the JAX package's."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from alifmm_tpu_torch import grid, materials, weld_data
from alifmm_tpu_torch.ops import cuda_planes
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "golden", "planes_jax.npz")
# make_model's cases against the JAX package: a 48 x 56 weld with the
# default tables, and chip_smoke's table and mixed cases
JAX_CASES = ("weld_48x56", "tables", "random")
DNX = 2e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K6 is a CUDA kernel and needs a CUDA device")
    return torch.device("cuda", 0)


def jax_case(name):
    """make_model's maps and tables (veln, velpn, vel_map, stif or None,
    group_tab, phase_tab) of ``JAX_CASES[name]``; the table and mixed
    cases give their group table as the phase table too."""
    if name == "weld_48x56":
        veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0, (48, 56))
        return (veln, velpn, vel_map, stif, *materials.default_tables())
    veln, velpn, vel_map, stif, tab, has_stif = chip_smoke.planes_case(name)
    return veln, velpn, vel_map, stif if has_stif else None, tab, tab


def jax_reference():
    """The JAX package's make_model planes in float64 of every case: on its
    maps (``.f64``) and on their float32 casts (``.f32in``, the inputs of
    a float32 build)."""
    from alifmm_tpu import grid as jgrid

    out = {}
    for name in JAX_CASES:
        veln, velpn, vel_map, stif, g, p = jax_case(name)
        for key, dt in (("f64", np.float64), ("f32in", np.float32)):
            cast = [None if a is None else np.asarray(a).astype(dt)
                    for a in (veln, vel_map, stif, g, p)]
            m = jgrid.make_model(cast[0], velpn, cast[1], cast[2], cast[3],
                                 cast[4], DNX, dtype=np.float64, device=False)
            out[f"{name}.{key}"] = np.asarray(m.fallback_slowness)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", chip_smoke.PLANES_CASES)
def test_planes_match_float64_twin(device, case, dtype):
    """Within one float32 ulp (float32) or 1e-12 relative (float64) of the
    float64 twin at every point and plane."""
    chip_smoke.check_planes(case, dtype, device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_model_on_the_card_launches_k6(device, dtype):
    """One K6 launch a build; the model's planes are K6's on its fields and
    every other field equals a model_from_numpy upload of the host
    fields."""
    chip_smoke.check_make_model_planes(dtype, device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", JAX_CASES)
def test_make_model_on_the_card_matches_jax(device, case, dtype):
    """make_model's planes on the card against the JAX package's make_model
    on the same maps: float32 within one float32 ulp of its float64 planes
    of the float32 casts, float64 within 1e-12 relative."""
    ref = np.load(REFERENCE)
    m = grid.make_model(*jax_case(case), DNX, dtype=dtype, device=device)
    got = m.fallback_slowness.cpu().numpy()
    if dtype == torch.float32:
        gap = chip_smoke.ulp_gap(got, ref[f"{case}.f32in"])
        assert gap <= chip_smoke.PLANES_MAX_ULP
    else:
        want = ref[f"{case}.f64"]
        rel = np.max(np.abs(got - want) / np.abs(want))
        assert rel <= chip_smoke.PLANES_RTOL_F64


@pytest.mark.gpu
def test_make_model_on_the_card_takes_any_memory_order(device):
    """Fortran-ordered and transposed maps and tables build the model of
    the C-ordered ones (K6 itself takes contiguous tensors only)."""
    chip_smoke.check_make_model_layouts(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", chip_smoke.PLANES_CASES)
def test_twin_is_the_jax_packages(case, dtype):
    """The port's numpy function, chip_smoke's twin on the card, equals the
    JAX package's bit for bit on each case's casts to ``dtype``."""
    from alifmm_tpu import grid as jgrid

    case = chip_smoke.planes_case(case)
    _, port = chip_smoke.planes_inputs(case, dtype)
    _, jax = chip_smoke.planes_inputs(
        case, dtype, twin=jgrid._np_fallback_slowness_planes)
    np.testing.assert_array_equal(port, jax)


def test_jax_reference_is_current():
    """golden/planes_jax.npz holds what the JAX package's make_model gives
    now."""
    want = jax_reference()
    ref = np.load(REFERENCE)
    assert sorted(ref.files) == sorted(want)
    for key, planes in want.items():
        np.testing.assert_array_equal(ref[key], planes, err_msg=key)


def _inputs(Z=3, X=4, dtype=torch.float32):
    """Valid host tensors of the wrapper's arguments (on the CPU)."""
    return dict(veln=torch.zeros(Z, X, dtype=dtype),
                velpn=torch.ones(Z, X, dtype=torch.int32),
                vel_map=torch.ones(Z, X, dtype=dtype),
                stif=torch.ones(Z, X, 5, dtype=dtype),
                group_tab=torch.ones(361, 2, dtype=dtype))


def _bad(kind):
    a = _inputs()
    if kind == "float16":
        a = _inputs(dtype=torch.float16)
    elif kind == "mixed_float":
        a["vel_map"] = a["vel_map"].double()
    elif kind == "velpn_int64":
        a["velpn"] = a["velpn"].long()
    elif kind == "vel_map_shape":
        a["vel_map"] = torch.ones(3, 5)
    elif kind == "stif_shape":
        a["stif"] = torch.ones(3, 4, 4)
    elif kind == "table_rows":
        a["group_tab"] = torch.ones(179, 2)
    elif kind == "one_axis":
        a = {k: v[0] if k != "group_tab" else v for k, v in a.items()}
    elif kind == "batched":
        a = {k: v[None] if k != "group_tab" else v for k, v in a.items()}
    elif kind == "not_contiguous":
        a["veln"] = torch.zeros(4, 3).t()
    elif kind == "not_a_tensor":
        a["veln"] = np.zeros((3, 4), np.float32)
    elif kind == "out_shape":
        a["out"] = torch.empty(3, 4, 4)
    return a


@pytest.mark.parametrize("kind, error", [
    ("cpu", ValueError), ("float16", TypeError), ("mixed_float", TypeError),
    ("velpn_int64", TypeError), ("vel_map_shape", ValueError),
    ("stif_shape", ValueError), ("table_rows", ValueError),
    ("one_axis", ValueError), ("batched", ValueError),
    ("not_contiguous", ValueError), ("not_a_tensor", TypeError),
    ("out_shape", ValueError)])
def test_wrapper_raises_before_any_launch(monkeypatch, kind, error):
    """Every check runs before the library is built or a launch counted:
    CPU tensors, a wrong dtype, shape or contiguity each raise."""

    def no_build(*_, **__):
        raise AssertionError("built before the inputs were checked")

    monkeypatch.setattr(cuda_planes, "build", no_build)
    n0 = cuda_planes.LAUNCHES
    a = _bad(kind)
    with pytest.raises(error):
        cuda_planes.fallback_planes(a["veln"], a["velpn"], a["vel_map"],
                                    a["stif"], a["group_tab"], True,
                                    out=a.get("out"))
    assert cuda_planes.LAUNCHES == n0


def test_cpu_build_keeps_the_host_planes():
    """make_model(device="cpu") launches nothing and keeps the numpy
    planes, cast to the model's dtype."""
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0, (24, 30))
    n0 = cuda_planes.LAUNCHES
    m = grid.make_model(veln, velpn, vel_map, stif, None, None, DNX,
                        device="cpu")
    assert cuda_planes.LAUNCHES == n0
    host = [np.asarray(a).astype(np.float32) for a in (veln, vel_map, stif)]
    want = grid._np_fallback_slowness_planes(
        host[0], np.asarray(velpn).astype(np.int32), host[1], host[2],
        m.group_tab.numpy(), True).astype(np.float32)
    np.testing.assert_array_equal(m.fallback_slowness.numpy(), want)


def test_cpu_build_takes_any_memory_order():
    """Fortran-ordered maps and tables build the C-ordered inputs' model,
    with every field contiguous."""
    veln, velpn, vel_map, stif = weld_data.weld_model_arrays(0, (24, 30))
    g, p = materials.default_tables()
    want = grid.make_model(veln, velpn, vel_map, stif, g, p, DNX,
                           device="cpu")
    got = grid.make_model(*[np.asfortranarray(a)
                            for a in (veln, velpn, vel_map, stif, g, p)],
                          DNX, device="cpu")
    for name in grid.TENSOR_FIELDS:
        a = getattr(got, name)
        assert a.is_contiguous(), name
        assert torch.equal(a, getattr(want, name)), name


if __name__ == "__main__":
    np.savez_compressed(REFERENCE, **jax_reference())
    print(f"wrote {REFERENCE}")
