"""The benchmark's tests import ``chipbench`` from the checkout's root and
the program from ``src``.

    python -m pytest -q chipbench/tests            # on the CPU, small sizes
    python -m pytest -q -m gpu chipbench/tests     # the card's tests, on the card
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA card, or a skip: the program's kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)
