"""One torch CPU thread while a port test module runs.

The suite runs six workers on the machine's cores, and each worker's torch
would start an OpenMP team as wide as the machine: the teams spin against
each other, and the port's decode loops of tiny ops ran 5-30 times slower
than alone. Each `tests/test_torch_*.py` imports `one_torch_thread`, which
sets one thread for its module and restores the count after it. No result
depends on it: the checks are the same with any thread count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
