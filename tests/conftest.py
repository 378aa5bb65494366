import os
import sys

# tests see exactly 1 device (the dry-run sets its own XLA_FLAGS; never set
# the 512-device override globally)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess/multidevice)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped without one)")
