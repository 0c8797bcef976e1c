"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): the marker of the tests that need a CUDA card, and
the fixture that decides, when a test runs, whether there is one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card's device, or a skip with the reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this test runs the kernels at their own sizes")
    return torch.device("cuda")
