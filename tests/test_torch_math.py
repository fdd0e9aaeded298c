"""PyTorch port, the twins' square root (alifmm_tpu_torch/ops/_math.py):
on CPU tensors bit for bit the IEEE square root of ``math.sqrt`` and
numpy, in float64 and float32, for seeded inputs, special values and 0-d
tensors; and no module of the port calling ``torch.sqrt`` past it.
PyTorch's own CPU ``torch.sqrt`` differs from the IEEE root by one ulp on
about 0.9 % of float64 inputs, which the solver's tied stencil choices
amplify (tests/test_torch_sweep.py's isotropic replace pass)."""

import math
import os
import re

import numpy as np
import pytest
import torch

from alifmm_tpu_torch.ops._math import sqrt
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "alifmm_tpu_torch")
SPECIAL = [0.0, -0.0, 1.0, 2.0, 4.0, 0.25, 1e-310, 5e-324, 1e300,
           math.inf, -1.0, -math.inf, math.nan]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sqrt_is_correctly_rounded(dtype):
    rng = np.random.default_rng(11)
    with np.errstate(over="ignore"):       # 1e300 is inf in float32
        x = np.concatenate([rng.uniform(0.0, 10.0, 500_000),
                            np.exp(rng.uniform(-80.0, 80.0, 500_000)),
                            SPECIAL]).astype(dtype)
    got = sqrt(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    got = got.numpy()
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))
    # math.sqrt rounds once in float64; a float32 root rounded from it is
    # the correctly rounded float32 root (53 >= 2 x 24 + 2 bits)
    want = np.array([math.sqrt(v) if v >= 0 else math.nan
                     for v in x.astype(np.float64)]).astype(dtype)
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:5]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sqrt_keeps_0d_and_strided_tensors(dtype):
    two = torch.tensor(2.0, dtype=dtype)
    got = sqrt(two)
    assert got.shape == () and got.dtype == dtype
    assert got.item() == float(np.sqrt(np.array(2.0, dtype=two.numpy().dtype)))
    if dtype == torch.float64:
        assert got.item().hex() == math.sqrt(2.0).hex()
        assert got.item().hex() == "0x1.6a09e667f3bcdp+0"
    grid = torch.arange(1.0, 25.0, dtype=dtype).reshape(4, 6)
    view = grid[:, ::2].t()
    assert torch.equal(sqrt(view),
                       torch.from_numpy(np.sqrt(view.numpy())))


def test_no_module_of_the_port_calls_torch_sqrt():
    """Every root of the twins goes through ops/_math.sqrt."""
    found = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py") or name == "_math.py":
                continue
            with open(os.path.join(root, name)) as f:
                for k, line in enumerate(f, 1):
                    code = line.split("#", 1)[0]
                    if re.search(r"torch\.sqrt\(|\.sqrt_?\(\)", code):
                        found.append(f"{name}:{k}")
    assert not found, found
