import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips on a host without one")


@pytest.fixture
def card():
    """The card, for the tests marked ``gpu``; decided here, in the test,
    never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
