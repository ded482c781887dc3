"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the root of the repository (the repository's ``tests/`` does not collect
them).  Tests marked ``cuda`` need the card and decide so in a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
