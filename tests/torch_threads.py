"""Shared autouse fixture of the port's tests: one torch CPU thread.

The test run puts several pytest workers on one machine, each beside
XLA's thread pool; torch's default of one OpenMP thread per core then
oversubscribes the cores, and its many small tensor ops slow down
several times over.  Import the fixture into a test module to apply it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
