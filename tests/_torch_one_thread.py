"""One intra-op thread for a port test module, as an autouse module
fixture (``from _torch_one_thread import _one_cpu_thread``).

The tests run in several pytest-xdist workers at once.  With PyTorch's
default of one intra-op thread a core, every worker's torch spins as
many OpenMP threads as the machine has cores against the other workers'
threads, and the small CPU ops of these tests spend more time waiting
for cores than computing.  One thread a worker computes the same cases
(a CPU run with one thread is also deterministic) in less time."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
