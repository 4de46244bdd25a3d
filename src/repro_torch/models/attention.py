"""GQA / MQA / MHA attention (counterpart of ``repro.models.attention``):
causal, sliding-window and local/global masks, soft-capping, qk-norm,
RoPE / M-RoPE and biases.

Three paths, by mode, each the reference's math in torch ops:

* :func:`mha_dense`   — train: materialized scores (the reference's bf16
  score product, then fp32 softmax);
* :func:`mha_chunked` — prefill: an online softmax over 1024-key blocks,
  padded key positions ``2**30`` (never attended);
* :func:`decode_attend` — decode: Q new queries against a ``[B,S,KV,hd]``
  cache (:func:`repro_torch.models.blocks.gqa_block` writes the cache
  first);

and the encoder-decoder's :func:`cross_attention` over the encoder's
k / v (:func:`cross_kv`, once a request).

Where the reference multiplies bf16 operands with fp32 accumulation
(``preferred_element_type=f32``) the port takes fp32 products of the
stored operands (:func:`~repro_torch.models.layers.bmm_f32`).  The
grouped products read ``k`` / ``v`` with their KV heads and the queries
as ``[B, KV, G, ...]`` (head ``h = kv * G + g``, ``repeat_kv``'s order):
the same function as repeating the cache to H heads, without the copy
(at decode, 1.08 GB a layer and round for qwen1.5-110b at B = 4,
S = 8224); at decode one KV head at a time, on the cache in place.  No Pallas kernel is on this path in the reference, and
``scaled_dot_product_attention`` would round otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import logical_axis_size, shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, _norm

NEG_INF = -2.0e38
PAD_POSITION = 2 ** 30           # padded key positions: never <= a query's
# elements of one fp32 score block of the prefill (1 GiB): the query
# chunk of mha_chunked
SCORE_BLOCK_ELEMS = 1 << 28


def attn_def(cfg: ArchConfig) -> dict:
    """The attention's parameter definitions (wq / wk / wv / wo, the qkv
    biases and the qk norms where the config has them).  A decoder's
    cross-attention has the same tree (the reference's ``cross=True``
    changes nothing): :func:`cross_kv` reads wk / wv (bk / bv) over the
    encoder's output, :func:`cross_attention` wq (bq) and wo."""
    dt = cfg.param_dtype
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": ParamDef((d, H, hd), dt, axes=("embed", "heads", None)),
         "wk": ParamDef((d, KV, hd), dt, axes=("embed", "kv", None)),
         "wv": ParamDef((d, KV, hd), dt, axes=("embed", "kv", None)),
         "wo": ParamDef((H, hd, d), dt, axes=("heads", None, "embed"))}
    if cfg.qkv_bias:
        p["bq"] = ParamDef((H, hd), dt, "zeros", ("heads", None))
        p["bk"] = ParamDef((KV, hd), dt, "zeros", ("kv", None))
        p["bv"] = ParamDef((KV, hd), dt, "zeros", ("kv", None))
    if cfg.qk_norm:
        p["q_norm"] = _norm(hd, dt, None)
        p["k_norm"] = _norm(hd, dt, None)
    return p


def project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor | None, *,
                rope_theta: float | None = None,
                mrope_positions: torch.Tensor | None = None):
    """x [B,S,d] -> q [B,S,H,hd], k, v [B,S,KV,hd] (roped, normed)."""
    q = L.proj(x, p["wq"])
    k = L.proj(x, p["wk"])
    v = L.proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if cfg.mrope_sections is not None and mrope_positions is not None:
        cos, sin = L.mrope_cos_sin(mrope_positions, cfg.head_dim,
                                   cfg.mrope_sections, theta)
    else:
        cos, sin = L.rope_cos_sin(positions, cfg.head_dim, theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (L.apply_rope(q, cos, sin, cfg.rope_interleaved),
            L.apply_rope(k, cos, sin, cfg.rope_interleaved), v)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B,S,KV,hd] -> [B,S,KV*groups,hd] for dense GQA math."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window=None) -> torch.Tensor:
    """Additive fp32 bias [*, Sq, Sk]: 0 where ``k_pos <= q_pos`` (and,
    with a ``window``, ``k_pos > q_pos - window``), else -2e38."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None and window > 0:
        ok = ok & (k_pos[..., None, :] > (q_pos[..., :, None] - window))
    return torch.where(ok, 0.0, NEG_INF).float()


def _scale(cfg: ArchConfig) -> float:
    return cfg.query_scale or cfg.head_dim ** -0.5


def kv_split(kv: int) -> bool:
    """Whether ``kv`` heads split over the logical ``kv`` axis's mesh
    dimensions (always outside a sharding context)."""
    n = logical_axis_size("kv")
    return kv % max(1, n) == 0 and kv >= n


def _grouped_q(q: torch.Tensor, kv: int) -> torch.Tensor:
    """q [B,Sq,H,hd] -> [B*KV, G*Sq, hd] (rows g-major, then queries).
    Under a sharding context the grouped view keeps the batch split and
    the heads' where the kv heads split too (the queries' sequence merges
    with the group dim: whole)."""
    B, Sq, H, hd = q.shape
    q = shard(q, "batch", None, "heads" if kv_split(kv) else None, None)
    return q.reshape(B, Sq, kv, H // kv, hd).permute(0, 2, 3, 1, 4).reshape(
        B * kv, (H // kv) * Sq, hd)


def scores(q: torch.Tensor, k: torch.Tensor, *, exact: bool = True
           ) -> torch.Tensor:
    """q [B,Sq,H,hd] . k [B,Sk,KV,hd] -> fp32 [B,H,Sq,Sk], KV dividing H.

    ``exact``: fp32 products of the stored operands (the reference's
    ``preferred_element_type=f32``); otherwise the product in the
    operands' dtype, widened after (its plain bf16 einsum)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = _grouped_q(q, KV)
    # [B*KV, Sk, hd] copied row by row, read transposed by the product
    kt = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd).transpose(1, 2)
    s = L.bmm_f32(qg, kt) if exact else torch.bmm(qg, kt).float()
    return s.view(B, H, Sq, Sk)


def weighted(w: torch.Tensor, v: torch.Tensor, *, exact: bool = True
             ) -> torch.Tensor:
    """w [B,H,Sq,Sk] . v [B,Sk,KV,hd] -> [B,H,Sq,hd]: fp32 when
    ``exact`` (products of the stored operands), else in w's dtype."""
    B, H, Sq, Sk = w.shape
    KV, hd = v.shape[2], v.shape[3]
    wg = w.reshape(B * KV, (H // KV) * Sq, Sk)
    vv = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    o = L.bmm_f32(wg, vv) if exact else torch.bmm(wg, vv)
    return o.view(B, H, Sq, hd)


def mha_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, scale: float, attn_cap: float | None
              ) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd], bias [B|1,1|H,Sq,Sk] ->
    [B,Sq,H,hd] in v's dtype: the score product rounded to the operands'
    dtype, softmax in fp32, weights cast to v's dtype (the reference's)."""
    s = scores(q, k, exact=False) * scale
    s = L.softcap(s, attn_cap) + bias
    w = torch.softmax(s, dim=-1)
    return weighted(w.to(v.dtype), v, exact=False).transpose(1, 2)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor, scale: float,
                attn_cap: float | None, window,
                kv_block: int = 1024) -> torch.Tensor:
    """Online softmax over ``kv_block`` key blocks (the inference path).

    q [B,Sq,H,hd]; k, v [B,Sk,KV,hd]; positions absolute.  Keys are padded
    to whole blocks at position ``2**30``.  Queries run in chunks that
    keep one fp32 score block within ``SCORE_BLOCK_ELEMS``: each query's
    online softmax is its own, so the chunking changes nothing."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    nb = -(-Sk // kv_block)
    pad = nb * kv_block - Sk
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], 1)
        v = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], 1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), PAD_POSITION)],
                          1)
    qc_len = max(1, SCORE_BLOCK_ELEMS // (B * H * kv_block))
    outs = []
    for q0 in range(0, Sq, qc_len):
        qc, pq = q[:, q0:q0 + qc_len], q_pos[:, q0:q0 + qc_len]
        n = qc.shape[1]
        m = torch.full((B, H, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, n, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nb):
            blk = slice(j * kv_block, (j + 1) * kv_block)
            s = scores(qc, k[:, blk]) * scale
            s = L.softcap(s, attn_cap)
            s = s + causal_mask_bias(pq[:, None, :], k_pos[:, None, blk],
                                     window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + weighted(p, v[:, blk].float())
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, 2).transpose(1, 2).to(q.dtype)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, bias: torch.Tensor, scale: float,
                  attn_cap: float | None, w_dtype: torch.dtype
                  ) -> torch.Tensor:
    """Q queries [B,Q,H,hd] against the cache [B,S,KV,hd] -> fp32
    [B,Q,H,hd]: fp32 scores of the stored operands, soft-capped, plus
    ``bias`` [B,1,Q,S], softmax, the weights cast to ``w_dtype`` (the
    cache's in ``gqa_block``, fp32 in :func:`attention`'s decode) and
    summed in fp32 against the cache's values."""
    B, Q, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = _grouped_q(q, KV).view(B, KV, -1, hd)            # [B,KV,G*Q,hd]
    # one KV head at a time: each product reads the cache where it lies
    # (rows KV*hd apart), so the cache is read once and never copied
    s = torch.stack([L.bmm_f32(qg[:, j], k_cache[:, :, j].transpose(1, 2))
                     for j in range(KV)], 1)               # [B,KV,G*Q,S]
    s = s.view(B, H, Q, S)
    # the scores take the cache's layout: heads where the kv heads split,
    # else the cache's sequence (launch/steps.annotate)
    if kv_split(KV):
        s = shard(s, "batch", "heads", None, None)
    else:
        s = shard(s, "batch", None, None, "seq_sp")
    s = L.softcap(s * scale, attn_cap) + bias
    w = torch.softmax(s, dim=-1).to(w_dtype).view(B, KV, -1, S)
    o = torch.stack([L.bmm_f32(w[:, j], v_cache[:, :, j])
                     for j in range(KV)], 1)               # [B,KV,G*Q,hd]
    return o.view(B, H, Q, hd).transpose(1, 2)


class AttnOutput(NamedTuple):
    out: torch.Tensor
    k: torch.Tensor | None = None   # new k / v for the cache (prefill)
    v: torch.Tensor | None = None


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, kind: str = "global",
              mode: str = "train", cache_k: torch.Tensor | None = None,
              cache_v: torch.Tensor | None = None,
              cache_positions: torch.Tensor | None = None,
              rope_theta: float | None = None,
              mrope_positions: torch.Tensor | None = None,
              window_override: int | None = None) -> AttnOutput:
    """Unified attention entry.

    ``mode``: "train" (:func:`mha_dense`), "prefill" (:func:`mha_chunked`)
    or "decode" (q against ``cache_k`` / ``cache_v``; the caller appends
    to the cache).  ``kind``: "global", or "local" (``cfg.sliding_window``).
    ``window_override``: a per-layer window (``2**30``: global)."""
    if window_override is not None:
        window = window_override
    else:
        window = cfg.sliding_window if kind == "local" else None
    scale = _scale(cfg)
    q, k, v = project_qkv(p, cfg, x, positions, rope_theta=rope_theta,
                          mrope_positions=mrope_positions)
    if cfg.num_heads % max(1, logical_axis_size("heads")) == 0:
        q = shard(q, "batch", None, "heads", None)
        k = shard(k, "batch", None, "kv", None)
        v = shard(v, "batch", None, "kv", None)
    else:
        # heads do not divide the model axis (whisper's 20 on 16): shard
        # the query sequence instead (k / v gathered, Megatron-SP style)
        q = shard(q, "batch", "seq_sp", None, None)
    if mode == "decode":
        bias = causal_mask_bias(positions[:, None, :],
                                cache_positions[:, None, :], window)
        o = decode_attend(q, cache_k, cache_v, bias, scale,
                          cfg.attn_softcap, torch.float32).to(x.dtype)
    elif mode == "prefill":
        o = mha_chunked(q, k, v, positions, positions, scale,
                        cfg.attn_softcap, window)
    elif mode == "train":
        groups = cfg.num_heads // cfg.num_kv_heads
        # positions are the same over the batch in training: one mask
        bias = causal_mask_bias(positions[:1, None, :],
                                positions[:1, None, :], window)
        o = mha_dense(q, repeat_kv(k, groups), repeat_kv(v, groups), bias,
                      scale, cfg.attn_softcap)
    else:
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    o = shard(o, "batch", None, "heads", None)
    return AttnOutput(L.proj(o, p["wo"], 2), k, v)


def cross_attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """The decoder's cross-attention over the encoder's k / v [B,Se,KV,hd]
    (whisper): unmasked, scores and softmax in fp32 (products of the
    stored operands), the fp32 output rounded to x's dtype before ``wo``."""
    q = L.proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    s = scores(q, enc_k) * _scale(cfg)
    w = torch.softmax(s, dim=-1)
    o = weighted(w, enc_v).transpose(1, 2).to(x.dtype)
    return L.proj(o, p["wo"], 2)


def cross_kv(p: dict, cfg: ArchConfig, enc_out: torch.Tensor):
    """The encoder's k / v [B,Se,KV,hd] for one decoder layer (computed
    once a request, at prefill)."""
    k = L.proj(enc_out, p["wk"])
    v = L.proj(enc_out, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v
