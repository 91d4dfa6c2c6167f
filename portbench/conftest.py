"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests -q``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run these on the chip")
    return torch.device("cuda")
