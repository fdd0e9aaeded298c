"""K1 (csrc/sweep.cu) against its plain PyTorch twin on a CUDA device.

K1 is CUDA C++ with no CPU mode, so these tests skip without a card; on
the card, ``python3 chip_smoke.py`` runs the same comparisons (it holds
the helpers used here) and ``python -m pytest tests/test_torch_kernel.py``
runs this file with ``--noconftest`` (tests/conftest.py imports jax,
which the card's host does not have).  Tolerances: 1e-12 (float64) and
1e-5 (float32) relative per pass; K1 is expected to equal the twin."""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel and needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", sorted(chip_smoke.PASS_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_pass_matches_plain_twin(device, dtype, case):
    """A min pass and a replace pass at every launch shape of the case."""
    chip_smoke.check_case(case, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_fixpoint_and_patches_match_plain_twin(device, dtype):
    chip_smoke.check_fixpoint(dtype, device)


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
