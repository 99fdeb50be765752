"""The port's CPU tests run torch on one intra-op thread.

The suite runs in parallel workers (``pytest -n``), beside gloo ranks and
XLA's own thread pools: a pool of one intra-op thread per core in every
worker left the cores oversubscribed, and torch's threads spinning at each
other's barriers made single tests tens of times slower than alone. Each
port test module takes :func:`one_torch_thread` in by importing it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module's tests run: as fast at their
    small shapes, and no oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
