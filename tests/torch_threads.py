"""The port's tests' cap on torch's intra-op threads.

The suite runs six test workers on eight cores, where torch's default of
a thread a core oversubscribes them and its parallel regions stall.  A
module that classifies or trains at more than a toy size applies the
fixture with ``pytestmark = pytest.mark.usefixtures("two_torch_threads")``
(after importing it); a subprocess takes ``TEST_THREADS`` as its
``OMP_NUM_THREADS``.
"""

import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(scope="module")
def two_torch_threads():
    """``TEST_THREADS`` torch intra-op threads while the module runs,
    the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)
