"""CPU tests of the benchmark harness: tiny geometries, the program's and the
reference's plain versions on the CPU."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
