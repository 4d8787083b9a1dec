"""The benchmark's own tests: ``pytest benchmark/tests`` from the repo root.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them when no CUDA device is present; the decision is
made inside the fixture, never at import time."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_archs():
    from benchmark.tests.tiny import register_tiny_archs

    register_tiny_archs()
    return True
