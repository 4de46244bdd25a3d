"""Multi-head Latent Attention + DSA lightning indexer (counterpart of
``repro.models.mla``).

A token's cache entry is its **latent row**
``concat(rmsnorm(c_kv) [kv_lora_rank], rope(k_pe) [qk_rope_head_dim])``
(576 dims at full width).  Decode attends in the *absorbed* form: MQA of
per-head 576-dim queries against the shared latent rows.  Attention over
two row sets (pool hits, fetched misses) returns unnormalized partials
that :func:`merge_partials` combines exactly.

The monolithic (all-in-HBM) attention of the model's three modes:

* :func:`sparse_mla_decode` — decode over a ``[B,S,D]`` cache: the
  indexer's exact top-k, then attention over the selected rows;
* :func:`mla_prefill_attend` — prefill: the reference's two-pass chunked
  flash with the exact top-k mask, or the same function by ids in query
  chunks (indexer, top-k, row gather, sparse-MLA partial), the route the
  card takes;
* :func:`mla_train_attend` — dense masked attention (plain torch).

``use_kernel`` picks the kernel wrappers or the plain version; by default
the kernels on CUDA tensors and the plain version on the CPU.
Both compute the same top-k set, with ``lax.top_k``'s tie order
(:func:`topk_desc`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.indexer import ops as idx_ops
from repro_torch.kernels.indexer import ref as idx_ref
from repro_torch.kernels.sparse_mla import ops as sk_ops
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


# ---------------------------------------------------------------------------
# Monolithic attention: decode, prefill, train
# ---------------------------------------------------------------------------

def partial_sparse_attend(q_comb: torch.Tensor, latents: torch.Tensor,
                          valid: torch.Tensor, cfg: ArchConfig) -> Partial:
    """Attend q [B,Q,H,D] to latents [B,K,D] shared over Q, with validity
    mask [B,K]; unnormalized fp32 partials (the plain oracle of
    ``kernels/sparse_mla``: products accumulate in fp32 on the operands'
    own dtype)."""
    rank = cfg.mla.kv_lora_rank
    s = torch.einsum("bqhd,bkd->bqhk", q_comb.float(),
                     latents.float()) * mla_scale(cfg)
    v = valid[:, None, None, :]
    s = torch.where(v, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(v, p, torch.zeros_like(p))
    # the reference casts p to the latents' dtype before the product
    o = torch.einsum("bqhk,bkv->bqhv", p.to(latents.dtype).float(),
                     latents[..., :rank].float())
    return Partial(o, m, p.sum(dim=-1))


def _use_kernel(use_kernel: bool | None, x: torch.Tensor) -> bool:
    return x.is_cuda if use_kernel is None else use_kernel


def sparse_mla_decode(p: dict, pi: dict, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, latent_cache: torch.Tensor,
                      idx_keys: torch.Tensor, cache_len: torch.Tensor,
                      use_kernel: bool | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Monolithic DSA decode: x [B,Q,d], latent_cache [B,S,D], idx_keys
    [B,S,Di], cache_len [B] -> (out [B,Q,d], top-k ids [B,Q,K]).

    Every query sees the positions ``< cache_len`` (the reference's rule).
    ``use_kernel`` (default: on CUDA tensors) selects through
    :func:`~repro_torch.kernels.indexer.ops.topk_select` and attends
    through :func:`~repro_torch.kernels.sparse_mla.ops
    .sparse_mla_gather_attend` (row gather + sparse-MLA partial);
    otherwise the plain version, fp32 throughout as the reference's."""
    S = latent_cache.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < cache_len[:, None]
    iq = indexer_query(pi, x)
    k = min(cfg.dsa.index_topk, S)
    q_comb = absorbed_query(p, cfg, x, positions)               # [B,Q,H,D]
    if _use_kernel(use_kernel, x):
        _, ids = idx_ops.topk_select(iq.q, iq.w, idx_keys, valid, k)
        out_lat = sk_ops.sparse_mla_gather_attend(
            q_comb, latent_cache, ids, valid, mla_scale(cfg),
            cfg.mla.kv_lora_rank)
    else:
        sc = idx_ref.indexer_scores_ref(iq.q, iq.w, idx_keys)
        ids = topk_ids(sc, k, valid[:, None, :])                # [B,Q,K]
        B, Q, K = ids.shape
        bi = torch.arange(B, device=x.device)[:, None, None]
        gl = latent_cache[bi, ids].float()                      # [B,Q,K,D]
        gv = valid[bi, ids]                                     # [B,Q,K]
        s = torch.einsum("bqhd,bqkd->bqhk", q_comb.float(),
                         gl) * mla_scale(cfg)
        s = torch.where(gv[:, :, None, :], s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        out_lat = torch.einsum("bqhk,bqkv->bqhv", w,
                               gl[..., :cfg.mla.kv_lora_rank]).to(x.dtype)
    return output_proj(p, cfg, out_lat), ids


def dsa_threshold(sc: torch.Tensor, k: int, valid: torch.Tensor
                  ) -> torch.Tensor:
    """Per-row k-th largest indexer score (selection threshold). [B,Q]"""
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    return torch.topk(sc, min(k, sc.shape[-1]), dim=-1).values[..., -1]


def dsa_keep_mask(sc: torch.Tensor, k: int, valid: torch.Tensor
                  ) -> torch.Tensor:
    """Exact top-k membership mask [..., S] with ``lax.top_k``'s tie
    order (the lowest index wins among equal scores, :func:`topk_desc`),
    and'ed with ``valid``: a ``>= threshold`` mask would admit every tie
    at the k-th score (the relu'd indexer emits many exact 0.0 ties)."""
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    ids = topk_desc(sc, min(k, sc.shape[-1]))
    keep = torch.zeros(sc.shape, dtype=torch.bool, device=sc.device)
    keep.scatter_(-1, ids, True)
    return keep & valid


def mla_train_attend(p: dict, pi: dict | None, cfg: ArchConfig,
                     x: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
    """Dense MLA with the DSA top-k mask (plain torch on every device;
    ``[B,H,S,S]`` fp32 scores, so short sequences only)."""
    m = cfg.mla
    S = x.shape[1]
    lat = latent_entries(p, cfg, x, positions)                  # [B,S,D]
    q_comb = absorbed_query(p, cfg, x, positions)               # [B,S,H,D]
    s = torch.einsum("bqhd,bkd->bhqk", q_comb.float(),
                     lat.float()) * mla_scale(cfg)
    causal = positions[:, None, :, None] >= positions[:, None, None, :]
    bias = torch.where(causal, 0.0, NEG_INF)
    if pi is not None and cfg.dsa is not None and cfg.dsa.index_topk < S:
        iq = indexer_query(pi, x)
        sc = idx_ref.indexer_scores_ref(iq.q, iq.w, indexer_keys(pi, x))
        keep = dsa_keep_mask(sc, cfg.dsa.index_topk, causal[:, 0])
        bias = bias + torch.where(keep[:, None], 0.0, NEG_INF)
    w = torch.softmax(s + bias, dim=-1)
    o_lat = torch.einsum("bhqk,bkv->bqhv", w,
                         lat[..., :m.kv_lora_rank].float())
    return output_proj(p, cfg, o_lat.to(x.dtype))


# the query chunk of the prefill's kernel route: rows [B, C, K, 576] bf16
# are 2.4 GB at B = 4, K = 2048
PREFILL_QUERY_CHUNK = 256


def mla_prefill_attend(p: dict, pi: dict | None, cfg: ArchConfig,
                       x: torch.Tensor, positions: torch.Tensor,
                       kv_block: int = 2048, *,
                       use_kernel: bool | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor | None]:
    """MLA prefill with the DSA selection.  Returns (out [B,S,d], latent
    rows [B,S,D], indexer keys [B,S,Di] or None without an indexer).

    The plain version (the default on the CPU) is the reference's
    algorithm: a streaming top-k threshold over ``kv_block`` key blocks,
    then a chunked online softmax keeping every score above the threshold
    and the first ``n_tie`` ties in index order (the exact top-k set);
    without DSA (no indexer, or ``index_topk >= S``) plain causal
    attention.  ``use_kernel`` (the default on CUDA) computes the same
    function by ids, ``PREFILL_QUERY_CHUNK`` queries at a time: the
    indexer over the causal keys, the exact top-``min(k, S)``
    (:func:`topk_select`), then :func:`sparse_mla_gather_attend` on the
    selected rows; with
    ``index_topk >= S`` that selects every causal position, as the plain
    version's causal attention does.  A ``[B,H,S,kv_block]`` fp32 score
    block of the plain version is 17 GB at full width (B = 4, S = 8192),
    the kernel route's rows 2.4 GB a chunk.

    The reference returns no indexer keys when ``index_topk >= S``; the
    port always returns them when there is an indexer (a decode step
    appends to them)."""
    lat = latent_entries(p, cfg, x, positions)
    ikeys = indexer_keys(pi, x) if pi is not None else None
    if _use_kernel(use_kernel, x):
        if ikeys is None:
            raise ValueError("the kernel route needs the DSA indexer")
        return _prefill_ids(p, pi, cfg, x, positions, lat, ikeys), lat, \
            ikeys
    return _prefill_dense(p, pi, cfg, x, positions, lat, ikeys,
                          kv_block), lat, ikeys


def _prefill_ids(p, pi, cfg, x, positions, lat, ikeys):
    S, C = x.shape[1], PREFILL_QUERY_CHUNK
    k = min(cfg.dsa.index_topk, S)
    outs = []
    for c0 in range(0, S, C):
        xs, ps = x[:, c0:c0 + C], positions[:, c0:c0 + C]
        causal = positions[:, None, :] <= ps[:, :, None]        # [B,C,S]
        iq = indexer_query(pi, xs)
        _, ids = idx_ops.topk_select(iq.q, iq.w, ikeys, causal, k)
        q_comb = absorbed_query(p, cfg, xs, ps)
        o_lat = sk_ops.sparse_mla_gather_attend(
            q_comb, lat, ids, causal, mla_scale(cfg), cfg.mla.kv_lora_rank)
        outs.append(output_proj(p, cfg, o_lat.to(x.dtype)))
    return torch.cat(outs, dim=1)


def _prefill_dense(p, pi, cfg, x, positions, lat, ikeys, kv_block):
    m = cfg.mla
    B, S, _ = x.shape
    dev = x.device
    kv_block = min(kv_block, S)
    pad = (-S) % kv_block
    nb = (S + pad) // kv_block
    q_comb = absorbed_query(p, cfg, x, positions).float()
    H = q_comb.shape[2]

    def blocks(t, value=0):
        """[B,S,...] -> [nb,B,kv_block,...], padded with ``value``."""
        if pad:
            t = torch.cat([t, t.new_full((B, pad) + t.shape[2:], value)], 1)
        return t.reshape(B, nb, kv_block, *t.shape[2:]).transpose(0, 1)

    pos_b = blocks(positions, 2 ** 30)                          # [nb,B,kb]
    thr = n_tie = iq = ik_b = None
    if pi is not None and cfg.dsa is not None and cfg.dsa.index_topk < S:
        k = cfg.dsa.index_topk
        iq = indexer_query(pi, x)
        ik_b = blocks(ikeys)
        # pass 1: streaming top-k threshold over the key blocks
        topv = torch.full((B, S, k), NEG_INF, dtype=torch.float32,
                          device=dev)
        for kc, pc in zip(ik_b, pos_b[:, 0]):
            sc = idx_ref.indexer_scores_ref(iq.q, iq.w, kc)     # [B,S,kb]
            sc = torch.where(pc[None, None, :] <= positions[:, :, None],
                             sc, torch.full_like(sc, NEG_INF))
            topv = torch.topk(torch.cat([topv, sc], -1), k, dim=-1).values
        thr = topv[..., -1]                                     # [B,S]
        # exact top-k, lax.top_k's ties: every score > thr, then only the
        # first (index order) n_tie scores == thr
        n_tie = k - (topv > thr[..., None]).sum(-1)             # [B,S]

    # pass 2: chunked online softmax over the latent blocks
    mx = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, m.kv_lora_rank), dtype=torch.float32,
                      device=dev)
    tie_seen = torch.zeros((B, S), dtype=torch.long, device=dev)
    for j, (lc, pc) in enumerate(zip(blocks(lat), pos_b)):
        s = torch.einsum("bqhd,bkd->bhqk", q_comb,
                         lc.float()) * mla_scale(cfg)
        okq = pc[:, None, :] <= positions[:, :, None]           # [B,S,kb]
        if thr is not None:
            sc = idx_ref.indexer_scores_ref(iq.q, iq.w, ik_b[j])
            gt = (sc > thr[..., None]) & okq
            eq = (sc == thr[..., None]) & okq
            # running index-order rank of threshold ties across blocks
            rank = tie_seen[..., None] + eq.long().cumsum(-1) - eq.long()
            okq = gt | (eq & (rank < n_tie[..., None]))
            tie_seen = tie_seen + eq.sum(-1)
        ok = okq[:, None]                                       # [B,1,S,kb]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(mx, s.amax(-1))
        pw = torch.exp(s - m_new[..., None])
        pw = torch.where(ok, pw, torch.zeros_like(pw))
        corr = torch.exp(mx - m_new)
        l = l * corr + pw.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkv->bhqv", pw, lc[..., :m.kv_lora_rank].float())
        mx = m_new
    o_lat = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
    return output_proj(p, cfg, o_lat.to(x.dtype))
