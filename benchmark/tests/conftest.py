"""The benchmark's own tests: ``pytest benchmark/tests``. Tests that need a
CUDA card carry the ``gpu`` marker and skip, inside the ``cuda`` fixture,
where there is none."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU models run faster, and several test workers do not fight,
    on one intra-op thread."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
