"""Plain PyTorch version of the lightning-indexer scoring kernel."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def indexer_scores_ref(q: torch.Tensor, w: torch.Tensor, keys: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """score[b,q,s] = sum_h w[b,q,h] * relu(q[b,q,h] . keys[b,s]) in fp32,
    ``-2e38`` where ``valid`` ([B,S] or [B,Q,S]) is False.

    q [B,Q,Hi,Di], w [B,Q,Hi], keys [B,S,Di] -> [B,Q,S]."""
    dots = torch.einsum("bqhk,bsk->bqhs", q.float(), keys.float())
    sc = torch.einsum("bqh,bqhs->bqs", w.float(), torch.relu_(dots))
    if valid is None:
        return sc
    if valid.dim() == 2:
        valid = valid[:, None, :]
    return sc.masked_fill_(valid.logical_not(), NEG_INF)
