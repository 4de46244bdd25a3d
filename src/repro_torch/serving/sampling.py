"""Token selection (counterpart of ``repro.serving.sampling``): greedy only.

Sampled requests (temperature, top-k, top-p) need the reference's
per-request keys, ``jax.random.fold_in`` over threefry and its
``categorical`` draw, reproduced bit for bit; that is not ported yet, and
the serve session refuses such a request at ``submit``.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the largest logit along the last axis (the first one among
    equal values, as ``jnp.argmax``), int64."""
    return logits.argmax(dim=-1)
