"""Tests of the benchmark's harness. ``python -m pytest benchmark/tests -q``
from the repository's root; the tests marked ``card`` need an NVIDIA card
and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control's TF32 products exist on the card only")
    return torch.device("cuda")
