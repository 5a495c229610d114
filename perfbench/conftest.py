"""pytest settings of the benchmark's own tests (``perfbench/tests``).

    python -m pytest perfbench/tests -q

The tests marked ``card`` need a CUDA card; the ``card`` fixture skips
them here, at run time (never while a module is imported).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
