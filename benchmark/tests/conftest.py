"""CPU tests of the benchmark's harness (python -m pytest benchmark/tests).

Tests that need a CUDA card carry the `card` marker and skip inside the
`card` fixture when there is none."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
