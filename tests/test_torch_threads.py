"""One torch intra-op thread per pytest-xdist worker.

Under ``pytest -n N`` every worker runs torch with its default intra-op
thread count (one per core), so N workers oversubscribe the cores and the
port's CPU tests slow down by two orders of magnitude (30 cases of
``test_torch_sweep_host.py`` in 6 parallel processes: 240 s each with the
default threads, 1.4 s each with one).  This module caps the count at 1 when
it is imported inside a worker (``PYTEST_XDIST_WORKER`` set).  Every xdist
worker collects every test file before it runs any test, so the cap holds
in every worker for the whole run, whichever file the worker is given.  A
run without xdist keeps torch's default.
"""
import os

import torch

IN_WORKER = bool(os.environ.get("PYTEST_XDIST_WORKER"))

if IN_WORKER:
    torch.set_num_threads(1)


def test_one_intra_op_thread_in_an_xdist_worker():
    if IN_WORKER:
        assert torch.get_num_threads() == 1
    else:
        assert torch.get_num_threads() >= 1
