"""Test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must see
1 device; only launch/dryrun.py forces the 512-device placeholder count."""
import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
