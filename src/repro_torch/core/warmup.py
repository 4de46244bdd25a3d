"""LRU-Warmup (paper section 3.2; counterpart of ``repro.core.warmup``):
preheat the Sparse Memory Pool from the top-K sets of the last ``W``
prefill windows, inserted oldest to newest so that the LRU order matches
early decode's accesses."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.models import mla as M


def lru_warmup(pool: LP.PoolState, host_latent: torch.Tensor,
               x_tail: torch.Tensor, idx_p: dict, idx_keys: torch.Tensor,
               lens: torch.Tensor, cfg: ArchConfig, *,
               slot_mask: torch.Tensor | None, layer: int = 0,
               batch_offset: int = 0,
               block_table: torch.Tensor | None = None,
               host_scales: torch.Tensor | None = None) -> LP.PoolState:
    """Seed the pool, in place.

    x_tail [B, W, d]: post-ln1 hidden states of the last W prefill tokens
    (the windows); idx_keys [B, S, Di] the whole indexer cache; lens [B].
    One indexer call scores all W windows; then each window's top-K set is
    looked up, its misses fetched from the tier (dequantized for a
    quantized one) and admitted, and the clock ticks, window by window (the
    reference's ``lax.scan``, here a loop), so the stamps rise with the
    windows.  ``slot_mask`` (required, keyword-only; ``None`` = every row
    live) freezes masked rows.  ``layer`` / ``batch_offset`` /
    ``block_table`` route the fetches through a stacked and/or paged
    tier."""
    B, W, _ = x_tail.shape
    S = idx_keys.shape[1]
    K = min(cfg.dsa.index_topk, S)
    valid_s = torch.arange(S, device=lens.device)[None, :] < lens[:, None]
    valid_w = valid_s[:, None].expand(B, W, S)
    # the kernel skips invalid keys; top-k masks them as the reference does
    sc = M.indexer_scores(M.indexer_query(idx_p, x_tail), idx_keys,
                          valid_w)                                # [B,W,S]
    ids_w = M.topk_ids(sc, K, valid_w)                            # [B,W,K]
    req_w = valid_w.gather(2, ids_w)
    for w in range(W):
        pool, lk, _ = LP.lookup(pool, ids_w[:, w], req_w[:, w], K,
                                slot_mask=slot_mask, dedup=False)
        rows = offload.gather_tier_rows(host_latent, host_scales,
                                        lk.miss_ids, layer=layer,
                                        batch_offset=batch_offset,
                                        block_table=block_table)
        pool = LP.admit(pool, lk.miss_ids, rows, slot_mask=slot_mask)
        pool = LP.tick(pool)
    return pool
