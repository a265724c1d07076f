"""An autouse fixture for the port's CPU test modules: torch computes on
one intra-op thread while the module's tests run, and on its own pool
again after them.

The tests' tensors are small, so a pool as wide as the machine gains them
little; and where several test processes share the cores, each with such a
pool, the pools' threads spin against one another and a test takes many
times longer. Import it into a module to use it:
``from tests.torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
