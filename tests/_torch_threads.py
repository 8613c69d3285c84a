"""One PyTorch intra-op thread for the port's CPU tests.

Imported by every ``tests/test_torch_*.py`` for its autouse fixture.  Run
with six pytest-xdist workers on an eight-core host, each torch process
would start an OpenMP pool of one thread per core, and those spinning
pools oversubscribe the cores: a test that takes 0.7 s alone took 158 s
beside five such processes, and 0.73 s with one thread per process.
The fixture sets one thread for a test module and restores the count
after it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
