"""Torch's CPU threads shared among the pytest-xdist workers.

Every xdist worker is a process of its own, and torch starts as many
OpenMP / MKL threads in each as the machine has cores: six workers on eight
cores ran about 48 busy threads on the port's small tensors, and the port's
test files took about three times the wall time and five times the CPU
time they take with one thread a worker.  The port's test modules import
this module, which gives each worker its share of the cores (at least one
thread); a run without xdist keeps torch's default.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
