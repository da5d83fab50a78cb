import os
import sys

# Make `repro` importable without installation (PYTHONPATH=src also works).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: do NOT set --xla_force_host_platform_device_count here.  Smoke tests
# and benches must see ONE device; multi-device tests run in subprocesses
# (see tests/test_dryrun_mini.py) where the flag is set before jax imports.

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips where none is available")
