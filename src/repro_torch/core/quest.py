"""Generalized ESS for GQA architectures (counterpart of
``repro.core.quest``).

The paper's indexer is DSA's; for plain-GQA archs (qwen, gemma, dbrx) the
offload design carries over if something else picks the hot cache
entries: Quest-style block scores [arXiv:2406.10774].  Per KV block keep
the elementwise (min, max) of the keys; a query's upper bound on its
attention score in the block is

    ub(q, block) = sum_d max(q_d * min_d, q_d * max_d)

The top blocks go through the same LRU Sparse Memory Pool (a block is a
page), misses come from the host tier, and attention over the selected
set is exact: selection approximate, attention exact, as DSA-ESS.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.attention import repeat_kv
from repro_torch.models.mla import topk_desc

NEG_INF = -2.0e38


class BlockMeta(NamedTuple):
    kmin: torch.Tensor    # [B, NB, KV, D] fp32
    kmax: torch.Tensor    # [B, NB, KV, D] fp32


def build_block_meta(k_cache: torch.Tensor, block: int) -> BlockMeta:
    """k_cache [B, S, KV, D] (S % block == 0) -> per-block min / max."""
    B, S, KV, D = k_cache.shape
    if S % block:
        raise ValueError(f"cache length {S} is not a multiple of {block}")
    kb = k_cache.reshape(B, S // block, block, KV, D).float()
    return BlockMeta(kb.amin(dim=2), kb.amax(dim=2))


def update_block_meta(meta: BlockMeta, k_new: torch.Tensor,
                      pos: torch.Tensor, block: int) -> BlockMeta:
    """Widen the meta in place for one new token per sequence: k_new
    [B, KV, D] at absolute positions ``pos`` [B] (a scatter-min and a
    scatter-max).  Returns ``meta``."""
    B, KV, D = k_new.shape
    idx = (pos // block).view(B, 1, 1, 1).expand(B, 1, KV, D)
    kn = k_new.float()[:, None]
    meta.kmin.scatter_reduce_(1, idx, kn, reduce="amin")
    meta.kmax.scatter_reduce_(1, idx, kn, reduce="amax")
    return meta


def quest_scores(q: torch.Tensor, meta: BlockMeta,
                 valid_blocks: torch.Tensor) -> torch.Tensor:
    """q [B, H, D] -> upper-bound block scores [B, NB], the max over
    heads (Quest §3.2); -2e38 where ``valid_blocks`` is False."""
    groups = q.shape[1] // meta.kmin.shape[2]
    kmin = repeat_kv(meta.kmin, groups)                  # [B,NB,H,D]
    kmax = repeat_kv(meta.kmax, groups)
    qf = q.float()[:, None]                              # [B,1,H,D]
    sc = torch.maximum(qf * kmin, qf * kmax).sum(-1).amax(-1)
    return torch.where(valid_blocks, sc, torch.full_like(sc, NEG_INF))


def quest_topk_blocks(q: torch.Tensor, meta: BlockMeta, lens: torch.Tensor,
                      block: int, topb: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (block ids [B, topb], valid [B, topb]).  The newest block is
    pinned at +inf (Quest keeps the recent window resident); ties take
    ``lax.top_k``'s order, the lowest block first (invalid blocks all tie
    at -2e38), through the stable descending sort."""
    B, NB = meta.kmin.shape[:2]
    n_valid = (lens + block - 1) // block
    valid = torch.arange(NB, device=lens.device)[None, :] < n_valid[:, None]
    sc = quest_scores(q, meta, valid)
    cur = ((lens - 1) // block).clamp(0, NB - 1)
    sc = sc.scatter(1, cur[:, None], float("inf"))
    ids = topk_desc(sc, min(topb, NB))
    return ids, valid.gather(1, ids)


def _block_positions(block_ids: torch.Tensor, block: int) -> torch.Tensor:
    """block ids [B, N] -> the positions they cover [B, N * block]."""
    offs = torch.arange(block, device=block_ids.device)
    return (block_ids[..., None] * block + offs).reshape(
        block_ids.shape[0], -1)


def gqa_sparse_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, block_ids: torch.Tensor,
                         bvalid: torch.Tensor, lens: torch.Tensor,
                         block: int, scale: float) -> torch.Tensor:
    """Exact attention over the selected blocks: q [B,H,D], k / v
    [B,S,KV,D], block_ids [B,NBSEL] -> [B,H,D] in q's dtype (fp32 scores
    of the stored operands, softmax, weights in the cache's dtype)."""
    B, S, KV, D = k_cache.shape
    groups = q.shape[1] // KV
    gidx = _block_positions(block_ids, block)            # [B, NBSEL*block]
    bi = torch.arange(B, device=q.device)[:, None]
    kk = repeat_kv(k_cache[bi, gidx], groups)            # [B,n,H,D]
    vv = repeat_kv(v_cache[bi, gidx], groups)
    pos_ok = (gidx < lens[:, None]) & bvalid.repeat_interleave(block, 1)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kk.float()) * scale
    s = torch.where(pos_ok[:, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(vv.dtype)
    return torch.einsum("bhs,bshd->bhd", w.float(), vv.float()).to(q.dtype)


def attention_recall(q: torch.Tensor, k_cache: torch.Tensor,
                     lens: torch.Tensor, block_ids: torch.Tensor,
                     bvalid: torch.Tensor, block: int, scale: float
                     ) -> torch.Tensor:
    """The share of the true softmax mass inside the selected blocks, per
    sequence, on its worst head [B] (Quest-ESS's quality metric)."""
    B, S, KV, D = k_cache.shape
    kk = repeat_kv(k_cache, q.shape[1] // KV)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kk.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)                         # [B,H,S]
    sel = torch.zeros((B, S), dtype=torch.bool, device=q.device).scatter_(
        1, _block_positions(block_ids, block).clamp(0, S - 1), True)
    mass = torch.where(sel[:, None], p, torch.zeros_like(p)).sum(-1)
    return mass.amin(dim=-1)
