"""An autouse fixture for the PyTorch port's CPU test modules: one
intra-op thread, in inference mode.  The plain twins issue thousands of
small operations, which one thread runs faster than a pool (a cut staged
solve on 48 x 56 takes 26 s with one thread and 32 s with eight), and the
test workers share the host's cores.  Inference mode skips autograd's
bookkeeping on each of those operations (nothing in the port takes a
gradient; the same kernels run, so the same bits): a cut staged solve on
30 x 39 takes 10.2 s in it and 13.6 s without.  A module imports
``one_torch_thread`` to use it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)
