"""The benchmark's weights: the port's parameter tree, drawn by the benchmark.

Shapes, dtypes and init families come from the port's definition tree
(``repro_torch.models.params.model_def``, the leaves ``abstract_params``
lays out); the numbers come from a ``torch.Generator`` of the benchmark's
own, seeded with the run's seed, one ``randn`` call a leaf in the dtype the
leaf is served in, on the run's device.  Normal leaves take
``1 / sqrt(fan_in)`` (fan-in: every dim but the last, as the port's
``init_params``), embeddings 0.02, norms and biases zeros.  The same
tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def draw(cfg, seed: int, device) -> dict:
    from repro_torch.models.params import map_defs, model_def

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def leaf(d):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        if d.init == "embed":
            std = d.scale if d.scale is not None else 0.02
        else:
            fan_in = max(1, math.prod(d.shape[:-1]))
            std = d.scale if d.scale is not None else fan_in ** -0.5
        t = torch.randn(d.shape, generator=g, dtype=d.dtype, device=device)
        return t.mul_(std)

    return map_defs(leaf, model_def(cfg))


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
