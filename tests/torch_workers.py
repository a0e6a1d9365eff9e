"""Cores for the port's CPU tests under pytest-xdist.

Each worker of ``pytest -n N`` is a process of its own, and PyTorch sizes
its intra-op thread pool to every core in each: six workers on eight
cores run 48 such threads, which oversubscribe the cores (a parallel op
waits for its slowest thread, and the threads wait for a core). While a
port test module runs, `share_cores` gives its worker 1/N of the cores,
in process and, through ``OMP_NUM_THREADS``, in the processes its tests
start. Without xdist PyTorch keeps its default. The thread count changes
the speed of PyTorch's CPU kernels, not what a test checks.

A port test module takes it with ``from tests.torch_workers import
share_cores  # noqa: F401`` (an autouse fixture).
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    n = max(1, len(os.sched_getaffinity(0)) // workers)
    prev, prev_env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
        if prev_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev_env
