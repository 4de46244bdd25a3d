"""The hand-written CUDA kernels of the port and their wrappers (one
package per TPU kernel family of the reference)."""

import torch

#: device types whose tensors take each wrapper's plain PyTorch version:
#: the CPU (the tests) and ``meta`` (the dry run: no data to launch on).
#: A CUDA tensor always takes the kernel.
PLAIN_DEVICES = ("cpu", "meta")


def refuse_dtensors(what: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor: a wrapper
    takes one rank's local tensors only, handed to it by
    :func:`repro_torch.distributed.sharding.local_call`, and never runs its
    plain version on a DTensor instead of its kernel."""
    for t in tensors:
        if t is None or type(t) is torch.Tensor:
            continue
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            raise TypeError(f"{what}: handed a DTensor; a kernel wrapper "
                            f"takes local tensors (call it through "
                            f"sharding.local_call)")
