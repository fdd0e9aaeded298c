"""An autouse fixture for the PyTorch port's CPU test modules: one
intra-op thread.  The plain twins issue thousands of small operations,
which one thread runs faster than a pool (a cut staged solve on 48 x 56
takes 26 s with one thread and 32 s with eight), and the test workers
share the host's cores.  A module imports ``one_torch_thread`` to use it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
