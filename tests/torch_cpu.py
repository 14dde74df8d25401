"""One intra-op torch thread in every process of the port's CPU tests.

The suite runs in several worker processes at once, and torch would
start a thread a core in each.  At the tests' sizes the port's plain
CPU path is a long run of small tensor operations, whose threads then
wait on each other across the workers and slow every proof down many
times over.  Each test module of the port imports this module, so a
worker runs on one thread from its collection on; the ranks
`torch_mesh.spawn` starts, and the subprocesses of the CLI and example
tests (``OMP_NUM_THREADS``), do the same.
"""

import torch

torch.set_num_threads(1)
