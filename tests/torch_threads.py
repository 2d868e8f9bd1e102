"""One torch intra-op thread for the port's CPU tests.

The test session runs several workers on shared cores, where torch's OpenMP
threads spin-wait for each other: a 30 s test of
``test_torch_demucs_v3_separator.py`` took 270 s in four workers at once,
and 28 s with one thread each. A test module opts in by importing the
fixture: ``from torch_threads import one_torch_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
