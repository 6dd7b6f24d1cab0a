"""One intra-op thread for the port's CPU tests (a fixture module, with
one test of its own).

The suite runs in several processes on a few cores (pytest-xdist), and
PyTorch gives each process a pool of as many threads as the machine has
cores; those pools spin against each other, which made the port's tests
four to five times slower in the suite than one thread each.  Every other
``tests/test_torch_*.py`` imports ``one_torch_thread``, an autouse fixture:
each of its tests runs with one thread, and the setting is restored after
it.  A test's results do not depend on it: the port's tests compare with
the JAX package within stated tolerances, or compare two port runs made
under the same setting.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_each_port_test_runs_with_one_thread():
    assert torch.get_num_threads() == 1
