"""The port's CPU tests run torch with one intra-op thread.

Their tensors are small (smoke widths), so extra threads buy nothing, and
torch's default of one OpenMP thread per core in each of the suite's
worker processes (``pytest -n 6``) oversubscribes the machine: six
concurrent runs of ``tests/test_torch_sampling.py`` took 771 s of wall
time with the default and 25 s with one thread each (19 s alone).  The
port's CPU test modules import this one; a worker that collects any of
them runs every test with one thread.
"""

import torch

torch.set_num_threads(1)
