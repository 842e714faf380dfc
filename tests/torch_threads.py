"""Caps torch's intra-op threads for the port's test modules when
pytest-xdist runs them: each of ``PYTEST_XDIST_WORKER_COUNT`` workers
gets its share of the cores instead of torch's default of one thread a
core in every worker at once.  Imported for this side effect by every
``tests/test_torch_*.py``; it changes no check."""

import os

import torch


def cap_threads() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


cap_threads()
