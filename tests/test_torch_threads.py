"""One intra-op thread for torch in every test process.

Tier-1 runs the suite in six xdist workers on the host's cores. torch's
default is a thread a core in each process, and its OpenMP threads wait
for each other at every parallel op: six workers' threads then share the
cores and each small op of the port's tests waits on preempted threads
(the port's tests took 901 s of wall in six workers with the default, 229 s
with one thread each, on an 8-core host). Every worker imports every test
module while it collects, before any test runs, so this module's import
sets the count for the whole process; the JAX package's tests do not read
it.
"""
import torch

torch.set_num_threads(1)


def test_one_torch_thread_a_process():
    assert torch.get_num_threads() == 1
