"""Intra-Layer Similarity, the paper's Eq. 1 (counterpart of
``repro.core.similarity``):

    r_t^l = |K_{t-1}^l ∩ K_t^l| / |K_t^l|

the temporal locality of a layer's top-k selection from one decode step
to the next, which the whole offload design rests on (paper §2.2,
Figure 2)."""

from __future__ import annotations

import torch


def intra_layer_similarity(prev_ids: torch.Tensor, cur_ids: torch.Tensor,
                           prev_valid: torch.Tensor | None = None,
                           cur_valid: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """prev_ids / cur_ids [..., K] -> similarity [...] in [0, 1], fp32.

    Membership by a K x K compare: exact set semantics while the ids of a
    row are unique (a top-k's are).  ``*_valid`` [..., K] drop entries;
    the denominator is then the valid current entries (at least 1)."""
    eq = cur_ids[..., :, None] == prev_ids[..., None, :]
    if prev_valid is not None:
        eq = eq & prev_valid[..., None, :]
    member = eq.any(dim=-1)
    if cur_valid is not None:
        member = member & cur_valid
        denom = cur_valid.sum(dim=-1).clamp_min(1)
    else:
        denom = cur_ids.shape[-1]
    return (member.sum(dim=-1) / denom).float()


def similarity_trace(ids_by_step: torch.Tensor) -> torch.Tensor:
    """ids_by_step [T, ..., K] -> r_t [T-1, ...], consecutive steps."""
    return intra_layer_similarity(ids_by_step[:-1], ids_by_step[1:])
