"""The port's CPU tests run torch with one intra-op thread, and, as a
pytest plugin, free JAX's compiled programs after each test file.

Their tensors are small (smoke widths), so extra threads buy nothing, and
torch's default of one OpenMP thread per core in each of the suite's
worker processes (``pytest -n 6``) oversubscribes the machine: six
concurrent runs of ``tests/test_torch_sampling.py`` took 771 s of wall
time with the default and 25 s with one thread each (19 s alone).  The
port's CPU test modules import this one; a worker that collects any of
them runs every test with one thread.

Every program JAX compiles stays in its caches, and each XLA CPU
executable holds memory maps of its own: a process that runs several
files which compile the reference (a pytest-xdist worker) passes the
kernel's limit of 65530 maps a process, and XLA's next compile aborts
(ROADMAP Queue 3).  A test module that runs the reference declares
``pytest_plugins = ("_torch_cpu",)``, which registers
:func:`pytest_runtest_protocol` below for the whole run: after the last
test of each file, whichever package it tests, it collects garbage and
clears JAX's caches, so each file starts from the maps it needs itself.

The reference's eager serve paths compile each primitive at each new
shape, and those compiles dominate the files that drive its sessions and
layers (``test_torch_session``, ``test_torch_overlap``, ``test_torch_tbo``:
1029 XLA compiles, 186 of 335 s, in ``test_torch_session``'s four stream
runs).  A file that marks itself with ``pytest.mark.usefixtures(
"quick_xla")`` has them compiled with ``jax_disable_most_optimizations``
(XLA's backend at its lowest optimization level, LLVM's expensive passes
off: the same operations, compiled in half the time), set for that file
only and restored after it.
"""

import gc
import sys

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quick_xla():
    """XLA's quick compiles (``jax_disable_most_optimizations``) for the
    tests of one file; the flag's value before it is restored after."""
    import jax
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """After a file's last test (its module fixtures torn down, the test's
    arguments dropped): ``gc.collect()``, then ``jax.clear_caches()``."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None and (nextitem is None or nextitem.path != item.path):
        gc.collect()
        jax.clear_caches()
        gc.collect()
