"""The port's test modules' shared fixture: one intra-op thread while a
module runs. Imported by every tests/test_torch_*.py module
(``from torch_one_thread import one_thread``), it applies to each of
their tests; the suite's own conftest.py is left as it is."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the port's many small
    CPU ops slow ~40x when the suite's workers oversubscribe the cores
    with OpenMP threads (a 10 s test took 590 s beside five others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
