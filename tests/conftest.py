# NOTE: do NOT set XLA_FLAGS here — smoke tests and benches must see 1 device;
# multi-device tests spawn subprocesses (tests/test_multidevice.py) and the
# dry-run sets its own flags as its first import action.
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
