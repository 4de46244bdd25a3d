"""Device meshes (counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks.

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` with named dimensions over
the default process group, which the caller initialises first (world
size at least the mesh's size; the dry run uses the ``fake`` backend,
the card a world of one).  A mesh smaller than the world takes ranks
``0 .. n-1``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks
    ``0 .. prod(shape)-1`` (the card's device type when there is one)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= int(s)
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).view(*[int(s) for s in shape]),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model_parallel: int = 1, device_type: str | None = None):
    """A ``(data, model)`` mesh over the ranks that exist (the world):
    ``model_parallel`` of them (at most the world) on ``model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    return init_device_mesh(_device_type(device_type), (n // mp, mp),
                            mesh_dim_names=("data", "model"))
