"""One torch thread in every process that runs the port's tests.

The suite runs in several pytest-xdist workers on one host, and torch
keeps by default an intra-op pool of one thread a core in each: the
workers then ask the cores for many times their number of threads, and
the port's small CPU tensors take several times as long for the same
results. Every worker imports every test module when it collects, before
its first test runs, so the count set here, at import, holds in every
worker for the whole run (and in a run of any set of files that includes
this one). The JAX package's thread pools are not torch's and stay as
they are.
"""

import torch

torch.set_num_threads(1)


def test_the_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
