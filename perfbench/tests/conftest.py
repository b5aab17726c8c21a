"""The benchmark's tests' card marker and fixture (the CPU-sized cells are
in ``small_cells.py``).

Run: ``python -m pytest perfbench/tests -q -o addopts=`` from the
repository's root; the tests marked ``cuda`` skip without a card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run these tests on the chip")
    return torch.device("cuda", 0)
