"""The benchmark's CPU tests run one torch thread each: the test runner's
workers share the machine's cores, and each worker's torch would
otherwise take all of them."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
