"""One torch thread a process while a port test module runs.

The suite runs with several pytest workers on one host, beside JAX's
thread pools.  Torch's default of one OpenMP thread per core makes every
op past the grain size a parallel region whose threads spin and wait
for each other on oversubscribed cores: under load a port module took
6x its time alone (tests/test_torch_bf16_stable.py, 277 s against 46 s,
with five busy matmul loops beside it), and at one thread it took its
time alone.  The nano models gain nothing from more threads.  The
fixture also sets ``OMP_NUM_THREADS`` for the processes a test starts,
and restores both afterwards.  Each port test module imports it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
