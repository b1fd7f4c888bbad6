"""Test configuration shared by the whole repository.

The port's CPU tests (`tests/test_torch_*.py`) run torch on one intra-op
thread.  The suite runs under 6 xdist workers on 8 cores, and torch's
default pool gives each worker a thread a core, so the workers' threads
oversubscribe the cores and the many small ops of these tests slow down by
an order of magnitude or more.  Every other test module (the JAX package's
tests, `ptbench/tests`) runs with the thread count it finds.
"""

from pathlib import Path

import pytest

_TESTS = Path(__file__).resolve().parent / "tests"


@pytest.fixture(autouse=True)
def _one_torch_thread(request):
    """One torch thread for each test of a `tests/test_torch_*.py` module,
    the count restored after it."""
    path = Path(request.path).resolve()
    if path.parent != _TESTS or not path.name.startswith("test_torch_"):
        yield
        return
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
