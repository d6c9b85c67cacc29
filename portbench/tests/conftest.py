"""The portbench tests: CPU tests, and tests marked `cuda` that need the
card and skip inside a fixture where there is none. Run from the repo root:

    python -m pytest portbench/tests -q              # here: the CUDA tests skip
    python -m pytest portbench/tests -q -m cuda      # on the card's machine
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: run on the card's machine")
    return torch.device("cuda:0")
