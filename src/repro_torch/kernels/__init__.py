"""The hand-written CUDA kernels of the port and their wrappers (one
package per TPU kernel family of the reference)."""

#: device types whose tensors take each wrapper's plain PyTorch version:
#: the CPU (the tests) and ``meta`` (the dry run: no data to launch on).
#: A CUDA tensor always takes the kernel.
PLAIN_DEVICES = ("cpu", "meta")
