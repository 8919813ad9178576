"""pytest settings of the benchmark's own tests.

Run from the repository root: ``python -m pytest port_bench/tests -q``. The
marker ``card`` marks tests that need a CUDA card; they skip without one,
decided inside the ``card`` fixture and never at import. On the chip:
``python -m pytest port_bench/tests -q -m card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
