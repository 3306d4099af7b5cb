import os

# Smoke tests and kernel tests see the single real CPU device; ONLY the
# dry-run scripts force 512 placeholder devices (per assignment).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
