"""The benchmark's tests run small models on the CPU beside the rest of
the suite's workers: each test takes one thread, and gives it back."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
