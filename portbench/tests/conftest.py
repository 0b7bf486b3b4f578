"""The benchmark's tests: on the CPU, but for those marked ``cuda``, which
need the card and skip without one (decided inside the ``card`` fixture,
never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
