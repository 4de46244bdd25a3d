"""PyTorch + CUDA port of the ESS reproduction (DeepSeek-V3.2-Exp serving).

Mirrors ``src/repro`` by sub-package (``configs``, ``models``, ``kernels``,
``core``, ``cache``, ``serving``, ``launch``).  Imports ``torch`` and numpy
only.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises instead of
    carrying on on the CPU.  ``"cpu"`` (or any explicit device) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the card: copied
    from pinned memory, non-blocking (a copy from pageable memory
    synchronizes).  On the CPU, ``t`` itself."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
