"""Pytest settings of the benchmark's own tests (``simbench/tests``).

``card`` marks a test that needs a CUDA device; the ``card`` fixture
decides at run time and skips where there is none. Run them on the card
with ``PYTHONPATH=src python -m pytest -q -m card --confcutdir=simbench
simbench/tests``.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
