"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which decides at run time whether a card is present
and skips on a machine without one.  On the card:

    python3 -m pytest benchmark/tests -m card -o addopts="" -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")
