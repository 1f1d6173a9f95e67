"""A fixture for the port's test modules whose CPU work is many small
torch ops (k-means, the engine): under parallel test workers torch's
intra-op threads oversubscribe the cores and each op waits on its pool
(a k-means pass ~100x slower with six workers on eight cores). Import
``one_torch_thread`` into a module to run it on one intra-op thread,
restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
