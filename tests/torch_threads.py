"""One intra-op PyTorch thread for a test module that runs PyTorch on the
CPU: the test run has several xdist workers, and each worker's own thread
pool (one thread a core) oversubscribes the cores beside the others, which
slowed such tests 40-100x. A module takes it with

    from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
