"""The CUDA kernels against their plain PyTorch twins on a CUDA device:
K1 (csrc/sweep.cu, its interpolated table lookup included), the ray
kernels K2 and K3 (csrc/rays.cu), with
their fine-path instantiations (nearest-point tap, exact materials,
fast-stride mask), K4, the descent march (csrc/descent.cu), and K5, the
slab sweep of the halo solves (csrc/sweep.cu).

The kernels are CUDA C++ with no CPU mode, so these tests skip without a
card; on the card, ``python3 chip_smoke.py`` runs the same comparisons (it
holds the helpers and case tables used here) and ``python -m pytest
tests/test_torch_kernel.py`` runs this file with ``--noconftest``
(tests/conftest.py imports jax, which the card's host does not have).
Tolerances: 1e-12 (float64) and 1e-5 (float32) relative per sweep pass,
segment, relaxation wave and ray time; the march as stated in
chip_smoke.py; K5 max abs 0.  The kernels are expected to equal the
twins."""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel and needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("model", chip_smoke.RAY_MODELS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segment_integrators_match_plain_twins(device, dtype, model):
    """Simpson 3 and 5, the crossing walk and the exact integrator on
    seeded segments (axis-aligned, zero-length, leaving the grid, longer
    than the crossing budget)."""
    chip_smoke.check_segments(model, dtype, device)


@pytest.mark.parametrize("knobs", sorted(chip_smoke.MARCH_KNOBS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_march_relax_and_times_match_plain_twins(device, dtype, knobs):
    """K2 on 48 x 56 with each of ``chip_smoke.MARCH_KNOBS``, then K3 on
    the marched polylines: one relaxation wave of each parity and scorer,
    and 0, 1 and 2 wave pairs followed by the ray times, with the tables
    in shared and in device memory."""
    chip_smoke.check_march(knobs, dtype, device)


@pytest.mark.parametrize("case", sorted(chip_smoke.FINE_MARCH_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fine_path_march_matches_plain_twin(device, dtype, case):
    """K2's fine-path instantiations on 48 x 56: the nearest-point tap on
    fields of the refined grid, the per-sample Christoffel materials (then
    K3 on the marched polylines), and the fast-stride mask."""
    chip_smoke.check_fine_march(case, dtype, device)


@pytest.mark.parametrize("model", chip_smoke.RAY_MODELS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exact_segment_integrators_match_plain_twins(device, dtype, model):
    """The four integrators on the stiffness rows of exact_materials."""
    chip_smoke.check_segments(model, dtype, device, exact=True)


@pytest.mark.parametrize("case", sorted(chip_smoke.DESCENT_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_descent_matches_plain_twin(device, dtype, case):
    """K4 on 48 x 56 with and without its scored window, on fields of the
    model grid and of the refined grid and on a model whose slow band
    bends the rays, against descent_plain ray for ray (bare, with the
    tables in shared and in device memory and with every step exact, and
    through the wrapper); trace_rays_descent against K3's twin on K4's
    polylines."""
    chip_smoke.check_descent(case, dtype, device)


def test_descent_wrapper_rejects_an_even_window(device):
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    model = chip_smoke.small_model(torch.float64, device)
    spec = rays.DescentSpec(9, 6.0, 10, 4, 1.0, False)
    ttf = torch.zeros((1, 48, 56), dtype=torch.float64, device=device)
    xy = torch.zeros((2, 2), dtype=torch.float64, device=device)
    idx = torch.zeros(2, dtype=torch.int64, device=device)
    with pytest.raises(ValueError):
        cuda_rays.march_descent(model, rays._material_flat(model), ttf, idx,
                                xy, xy, spec)


def test_ray_wrappers_reject_mismatched_tensors(device):
    from alifmm_tpu_torch import rays
    from alifmm_tpu_torch.ops import cuda_rays

    model = chip_smoke.small_model(torch.float64, device)
    mat_flat = rays._material_flat(model)
    xs = torch.zeros((4, 6), dtype=torch.float64, device=device)
    lengths = torch.full((4,), 6, dtype=torch.int64, device=device)
    with pytest.raises(TypeError):
        cuda_rays.ray_times(model, mat_flat, xs.float(), xs.float(), lengths,
                            9, 5)
    with pytest.raises(ValueError):
        cuda_rays.relax_wave(model, mat_flat, xs, xs[:, :-1], lengths, 9, 1,
                             9.0)
    with pytest.raises(TypeError):
        cuda_rays.ray_times(model, mat_flat, xs, xs, lengths.int(), 9, 5)


@pytest.mark.parametrize("case", sorted(chip_smoke.PASS_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_pass_matches_plain_twin(device, dtype, case):
    """A min pass and a replace pass at every launch shape of the case."""
    chip_smoke.check_case(case, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_fixpoint_and_patches_match_plain_twin(device, dtype):
    chip_smoke.check_fixpoint(dtype, device)


@pytest.mark.parametrize("case", sorted(chip_smoke.QSV_PASS_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_table_lookup_matches_plain_twin(device, dtype, case):
    """K1's interpolated table lookup (a qSV table column, column mode 2):
    a min pass and a replace pass, max abs 0 against the graphed twin."""
    chip_smoke.check_qsv_case(case, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_qsv_fixpoint_matches_plain_twin(device, dtype):
    """The fixpoint under for_mode("qsv")'s final-stage budget."""
    chip_smoke.check_qsv_fixpoint(dtype, device)


def test_k1_wrapper_rejects_mismatched_planes(device):
    from alifmm_tpu_torch.ops import cuda_sweep

    model = chip_smoke.small_model(torch.float64, device)
    tt, fixed = chip_smoke.seeded(model.shape, 2, torch.float64, device)
    packed = cuda_sweep.pack_model(model)
    with pytest.raises(TypeError):
        cuda_sweep.sweep_pass(tt.float(), model, fixed, False, packed=packed)
    with pytest.raises(ValueError):
        cuda_sweep.sweep_pass(tt[:, :-1], model, fixed[:, :-1], False,
                              packed=packed)


@pytest.mark.parametrize("case", sorted(chip_smoke.HALO_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_matches_plain_twin(device, dtype, case):
    """K5 on virtual ranks of the card against its graphed twin, bit for
    bit, halos included: every directional sweep of a halo pass (a
    refreshed sweep in one launch), min and replace, in slab_config's
    layout and the case's forced ones (c = 1, ragged tiles, the per-line
    schedule), then a halo pass and the wrapper."""
    chip_smoke.check_halo_case(case, dtype, device)
