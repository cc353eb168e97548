"""One torch thread count for the port's CPU test modules.

Under ``pytest -n N`` (xdist) every worker's torch would take all the
machine's cores, N workers would oversubscribe them N-fold, and the plain
versions' loops of small operators slow down many times over.  A port test
module imports ``worker_threads`` (an autouse, module-scoped fixture): its
tests run with ``cpu_count // N`` torch threads (at least one), and the
old count comes back after them.  A serial run (N = 1) keeps every core.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def worker_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)
