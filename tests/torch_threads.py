"""A module-scoped fixture for the port's CPU test files: torch runs them
on one intra-op thread.

The tests run in several pytest-xdist workers on one machine. Each worker
process would otherwise start one torch thread per core, so the workers
oversubscribe the cores, and the port's tests took about twice the CPU
time (on an 8-core machine with 6 workers: 13.2 against 7.0 CPU minutes,
133 against 97 s of wall time) while the JAX package's tests beside them
waited for cores. The tensors are small, so one thread is as fast.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
