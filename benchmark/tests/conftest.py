"""The benchmark's own tests (``python -m pytest benchmark/tests``); the
repository's ``pytest tests/`` does not collect them.  Tests that need a
card carry the ``cuda`` mark and skip inside the test without one."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
