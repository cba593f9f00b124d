"""The benchmark's own tests: CPU rehearsals of every cell, the
reference against the golden corpus, the control and the faults.

    python3 -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA device; each decides inside the test
whether one is present, and skips without one.
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
