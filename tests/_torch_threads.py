"""Cap torch's intra-op threads in a pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module first. Under xdist
(``PYTEST_XDIST_WORKER_COUNT`` set) each worker would otherwise run torch
with one OpenMP thread per core, so the workers' threads oversubscribe the
cores many times over and spin against each other. The cap is the cores
over the workers (at least 1), set for this process and, through
``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` (unless already set), for the
processes it starts: a CLI call's subprocess, ``run_ranks``'s ranks. A
serial run keeps torch's default."""

import os

import torch

__all__ = ["THREADS"]


def _cap():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    n = max(1, (os.cpu_count() or 1) // max(1, int(workers)))
    torch.set_num_threads(n)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(n))
    return n


#: the cap set in this process (None: not under xdist, nothing capped)
THREADS = _cap()
