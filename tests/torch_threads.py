"""The torch threads of the port's tests.

Under pytest-xdist every worker's torch would start one thread per core,
and the workers' threads would contend for the same cores: on an 8-core
host under ``-n 6 --dist loadfile`` the port's slowest test files took
499 s with torch's default threads and 140 s with one thread a worker.
So each worker takes its share of the cores when this module is first
imported (``torch_parity`` imports it, and every worker collects every
test module), and the children the tests start take the same share
(``child_env``).
"""
import os

import torch


def share_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


def child_env(**extra):
    """``os.environ`` for a test's child process, with ``extra`` and this
    process's torch thread count."""
    return dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
                **extra)


share_the_cores()
