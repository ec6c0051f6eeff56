"""One torch intra-op thread for a port test file.

The suite runs in six pytest-xdist workers on eight cores, and some
files start child processes besides. Each torch process's thread pool
(one thread a core) then oversubscribes the cores, and the waiting
threads slow small CPU ops many times over: alone a test of
``tests/test_torch_ssd_scan.py`` took 1.6 s, beside three other files
93 s. A port test file imports :func:`one_torch_thread`, an autouse
module fixture, and a child process that runs torch gets
:func:`one_thread_env`.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_thread_env(**extra) -> dict:
    """This process's environment for a child that runs torch, with one
    OpenMP thread."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)
