"""The benchmark's CPU tests run from the repository's root:
``python -m pytest benchmark/tests -q``. Tests marked ``gpu`` need a card
and are decided inside the ``cuda`` fixture."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skipped without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
