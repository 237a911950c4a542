import os

# Tests run on the single real CPU device (the dry-run sets its own
# XLA_FLAGS in a separate process; never set device_count here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# hypothesis is optional: register the CI profile only when present so
# the suite still collects on minimal environments (the property-based
# tests themselves skip via tests/_hyp.py).
try:
    from hypothesis import settings
except ImportError:
    settings = None

if settings is not None:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skips without one "
                   "(run on the card: python -m pytest -m cuda "
                   "tests/test_torch_cuda.py)")
