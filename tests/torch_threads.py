"""One torch intra-op thread for the port's tests.

A test file that runs torch in its own process imports the fixture::

    from tests.torch_threads import one_torch_thread  # noqa: F401

The models there are small, and the test workers share the machine's
cores: torch's default pool (a thread a core, spinning between parallel
regions) in every worker makes them fight for the cores, and a file ran
tens of times slower in the suite than alone. Processes a test starts
set their own (``tests/torch_parallel_worker.py``).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
