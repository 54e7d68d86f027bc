"""One torch thread a core per pytest-xdist worker.

Every port test module imports this module. Under ``-n N`` each worker
process runs one test at a time, and torch's default intra-op pool (a
thread a core) in each of N workers oversubscribes the machine: on an
8-core x86 CPU, TPC-DS q67 through the port's CPU path took 8.2 s in one
process and 240 s in each of six processes started together, 33 s each
at one thread. So a worker gets cores / N threads (at least one); a run
without xdist keeps every core. Thread counts change no check: float sums are compared
within tolerances, everything else exactly.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)


def test_threads_per_worker():
    assert torch.get_num_threads() == THREADS
