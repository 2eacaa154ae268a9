"""The benchmark's own tests.  Tests that need an NVIDIA GPU take the
``card`` fixture and carry the ``card`` marker: the fixture decides at run
time, never at import, and skips with a reason where there is no card.
Run here with ``python -m pytest portbench/tests -q``; on the card the
same command runs the marked tests too."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parents[0]), str(HERE.parents[1])]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch
