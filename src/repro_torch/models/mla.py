"""Multi-head Latent Attention + DSA lightning indexer (counterpart of
``repro.models.mla``, the decode/serve subset).

A token's cache entry is its **latent row**
``concat(rmsnorm(c_kv) [kv_lora_rank], rope(k_pe) [qk_rope_head_dim])``
(576 dims at full width).  Decode attends in the *absorbed* form: MQA of
per-head 576-dim queries against the shared latent rows.  Attention over
two row sets (pool hits, fetched misses) returns unnormalized partials
that :func:`merge_partials` combines exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.indexer import ops as idx_ops
from repro_torch.models import layers as L

NEG_INF = -2.0e38


def mla_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def latent_entries(p: dict, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """x [B,S,d] -> latent rows [B,S,latent_dim] (rope baked in)."""
    m = cfg.mla
    c_kv = L.rmsnorm(p["kv_norm"], x @ p["w_dkv"], cfg.norm_eps)
    k_pe = (x @ p["w_kr"])[:, :, None, :]              # [B,S,1,rope]
    cos, sin = L.rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    k_pe = L.apply_rope(k_pe, cos[:, :, None, :], sin[:, :, None, :])[:, :, 0]
    return torch.cat([c_kv, k_pe.to(c_kv.dtype)], dim=-1)


def absorbed_query(p: dict, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """x [B,Q,d] -> MQA query over the latent space [B,Q,H,latent_dim]."""
    m = cfg.mla
    cq = L.rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = torch.einsum("bql,lhk->bqhk", cq, p["w_uq"])    # [B,Q,H,nope+rope]
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = L.rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_pe = L.apply_rope(q_pe, cos[:, :, None, :], sin[:, :, None, :])
    # absorb W_uk: q_lat = q_nope @ W_uk^T (per head)
    q_lat = torch.einsum("bqhk,lhk->bqhl", q_nope, p["w_uk"])
    return torch.cat([q_lat, q_pe.to(q_lat.dtype)], dim=-1)


def output_proj(p: dict, cfg: ArchConfig, o_lat: torch.Tensor
                ) -> torch.Tensor:
    """o_lat [B,Q,H,kv_lora_rank] -> [B,Q,d] (absorbed W_uv then W_o)."""
    o = torch.einsum("bqhl,lhv->bqhv", o_lat, p["w_uv"])
    return torch.einsum("bqhv,hvd->bqd", o, p["wo"])


# ---------------------------------------------------------------------------
# Indexer (DSA)
# ---------------------------------------------------------------------------

def indexer_keys(pi: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-token indexer key [B,S,index_dim] — the Indexer-Cache entry."""
    return x @ pi["w_ik"]


class IndexerQuery(NamedTuple):
    q: torch.Tensor       # [B,Q,Hi,Di]
    w: torch.Tensor       # [B,Q,Hi]


def indexer_query(pi: dict, x: torch.Tensor) -> IndexerQuery:
    return IndexerQuery(torch.einsum("bqd,dhk->bqhk", x, pi["w_iq"]),
                        x @ pi["w_iw"])


def indexer_scores(iq: IndexerQuery, keys: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """score[b,q,s] = sum_h w[b,q,h] * relu(q[b,q,h] . k[b,s]) (fp32),
    through the indexer kernel; ``-2e38`` where ``valid`` [B,S]/[B,Q,S]
    is False (the kernel then skips those keys)."""
    return idx_ops.indexer_scores(iq.q, iq.w, keys, valid)


def topk_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis with ``lax.top_k``'s
    tie order (the lowest index wins among equal values)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_ids(scores: torch.Tensor, k: int,
             valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k cache indices per query row. scores [B,Q,S] -> ids [B,Q,k]."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF))
    return topk_desc(scores, k)


# ---------------------------------------------------------------------------
# Partials + exact merge
# ---------------------------------------------------------------------------

class Partial(NamedTuple):
    """Unnormalized attention partial (flash-decoding statistics)."""
    o: torch.Tensor       # [B,Q,H,rank]  sum_j exp(s_j - m) * v_j
    m: torch.Tensor       # [B,Q,H]       running max
    l: torch.Tensor       # [B,Q,H]       sum_j exp(s_j - m)


def merge_partials(a: Partial, b: Partial) -> Partial:
    m = torch.maximum(a.m, b.m)
    ca = torch.exp(a.m - m)
    cb = torch.exp(b.m - m)
    return Partial(a.o * ca[..., None] + b.o * cb[..., None], m,
                   a.l * ca + b.l * cb)


def finalize_partial(pt: Partial, dtype=torch.bfloat16) -> torch.Tensor:
    return (pt.o / pt.l.clamp_min(1e-30)[..., None]).to(dtype)
