"""One intra-op thread for the benchmark's CPU tests: the suite runs
several workers at once, and torch's thread pools oversubscribed across
them run many times slower."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
