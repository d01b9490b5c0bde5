"""The benchmark's tests: ``python -m pytest portbench/tests`` from the
repository's root. Tests marked ``cuda`` need a card and skip without one
(decided in the ``card`` fixture, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell's kernels and timings exist only on one")
    return torch.device("cuda")
