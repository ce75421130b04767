"""An autouse fixture for the port's test modules: torch's intra-op
threads capped at 1 while a module runs, and restored after it.

Tier-1 runs six pytest workers on one host, each of whose torch would
otherwise start a thread per core; capped, the workers contend less
with each other and with the reference's wall-clock lint gate (a second
intra-op thread waits and spins more than it computes on the port's
small test shapes). A test module takes it with ``from
test_torch_threads import capped_torch_threads``.
"""
import pytest
import torch

TORCH_TEST_THREADS = 1


@pytest.fixture(autouse=True, scope="module")
def capped_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(TORCH_TEST_THREADS)
    yield
    torch.set_num_threads(old)


def test_torch_runs_on_the_capped_thread_count():
    assert torch.get_num_threads() == TORCH_TEST_THREADS
