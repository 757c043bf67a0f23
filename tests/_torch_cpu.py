"""One torch thread pool per CPU share for the port's tests.

Under pytest-xdist every worker runs its own torch, whose intra-op pool has
a thread for each CPU of the machine: six workers on eight CPUs spin 48
threads, and the heaviest of the port's tests take twice as long as they
do alone. Every ``tests/test_torch_*.py`` imports this module before it does
any torch work. Under xdist it gives the worker's torch ``cpu_count //
workers`` threads, at least one. Outside xdist it leaves torch's default
alone. :func:`child_env` is the environment for a child process that a test
starts: under xdist ``OMP_NUM_THREADS`` is the same count.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def share() -> Optional[int]:
    """This xdist worker's threads: the CPUs over the workers, at least one;
    None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


def apply() -> Optional[int]:
    """Set torch's threads to :func:`share`; leave them alone outside xdist."""
    n = share()
    if n is not None:
        torch.set_num_threads(n)
    return n


def child_env(**extra: str) -> dict[str, str]:
    """``os.environ`` with ``extra``, and under xdist ``OMP_NUM_THREADS`` at
    this worker's share."""
    env = dict(os.environ, **extra)
    n = share()
    if n is not None:
        env["OMP_NUM_THREADS"] = str(n)
    return env


apply()
