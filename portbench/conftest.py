"""The benchmark's CPU tests run tiny models: one intra-op thread each, so
that the parallel workers of a test run do not contend (restored after)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
