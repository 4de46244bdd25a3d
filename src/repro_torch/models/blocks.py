"""The blocks of the model stacks (counterpart of ``repro.models.blocks``):
the GQA block (attention, a decoder's cross-attention over the encoder's
k / v, then the dense MLP or the MoE; gemma's post-block norms), the MLA
block (MLA attention, with or without the DSA indexer, then the FFN) and
the SSM block (a Mamba2 mixer), pre-norms and residuals.

The cache of one layer is a :class:`GQACache` or an :class:`MLACache` of
``[B,S,...]`` planes, or an :class:`~repro_torch.models.ssm.SSMState`.  A decode step appends its tokens' rows **in place**
(a view of the model's stacked ``[L,B,S,...]`` cache is written through),
with no host sync, so the step can be replayed as a CUDA graph; a
prefill returns new planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lru_pool import put_drop
from repro_torch.distributed.sharding import local_call
from repro_torch.kernels.sparse_mla import ops as sk_ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import _norm


# ---------------------------------------------------------------------------
# GQA block (dense or MoE FFN)
# ---------------------------------------------------------------------------

class GQACache(NamedTuple):
    k: torch.Tensor          # [B, S, KV, hd]
    v: torch.Tensor


def _append_at(planes, new, lens: torch.Tensor) -> None:
    """In place ``plane[b, lens[b] + q] = new[b, q]`` for each pair of
    ``planes`` and ``new`` ([B,S,...] and [B,Q,...]); offsets ``>= S``
    are dropped (the reference's ``.at[...].set(mode="drop")``)."""
    Q, S = new[0].shape[1], planes[0].shape[1]
    idx = lens[:, None] + torch.arange(Q, device=lens.device)[None, :]
    keep = idx < S
    idx = idx.clamp(0, S - 1)
    for dst, val in zip(planes, new):
        put_drop(dst, idx, val, keep)


def _write_cache(cache: GQACache, k_new: torch.Tensor, v_new: torch.Tensor,
                 lens: torch.Tensor) -> GQACache:
    """Write the Q new tokens' k / v at per-sequence offsets ``lens``, in
    place; returns ``cache``."""
    _append_at(cache, (k_new, v_new), lens)
    return cache


def gqa_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, mode: str, kind: str = "global",
              cache: GQACache | None = None,
              lens: torch.Tensor | None = None,
              cache_positions: torch.Tensor | None = None,
              rope_theta: float | None = None,
              mrope_positions: torch.Tensor | None = None,
              enc_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              window_override: int | None = None, moe: bool = False,
              train: bool = False):
    """Returns ``(y, new_cache, moe_aux | None)``.

    ``"decode"`` writes the new tokens into ``cache`` first (in place), so
    they attend to themselves and, causally, to each other, then attends
    over the cache (:func:`~repro_torch.models.attention.decode_attend`);
    ``"prefill"`` returns a new cache of the prompt's k / v.  With
    ``enc_kv`` (a decoder layer's encoder k / v) the cross-attention runs
    after the self-attention, on its own pre-norm (``ln_cross``)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        q, k, v = A.project_qkv(p["attn"], cfg, h, positions,
                                rope_theta=rope_theta,
                                mrope_positions=mrope_positions)
        cache = _write_cache(cache, k, v, lens)
        window = window_override if window_override is not None else \
            (cfg.sliding_window if kind == "local" else None)
        bias = A.causal_mask_bias(positions[:, None, :],
                                  cache_positions[:, None, :], window)
        o = A.decode_attend(q, cache.k, cache.v, bias, A._scale(cfg),
                            cfg.attn_softcap, cache.v.dtype)
        attn_out = L.proj(o.to(x.dtype), p["attn"]["wo"], 2)
    elif mode in ("prefill", "train"):
        ao = A.attention(p["attn"], cfg, h, positions, kind=kind, mode=mode,
                         rope_theta=rope_theta,
                         mrope_positions=mrope_positions,
                         window_override=window_override)
        if mode == "prefill":
            cache = GQACache(ao.k, ao.v)
        attn_out = ao.out
    else:
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    if cfg.post_block_norm:
        attn_out = L.rmsnorm(p["ln1_post"], attn_out, cfg.norm_eps)
    x = x + attn_out
    if enc_kv is not None:
        hc = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + A.cross_attention(p["cross"], cfg, hc, *enc_kv)
    f, aux = ffn(p, cfg, x, moe, train)
    if cfg.post_block_norm:
        f = L.rmsnorm(p["ln2_post"], f, cfg.norm_eps)
    return x + f, cache, aux


# ---------------------------------------------------------------------------
# MLA block (DeepSeek): MLA attention, with or without the DSA indexer
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    latent: torch.Tensor     # [B, S, latent_dim]
    ikeys: torch.Tensor      # [B, S, index_dim] ([B, S, 1] zeros: no DSA)


def mla_write_cache(cfg: ArchConfig, p: dict, cache: MLACache,
                    x_norm: torch.Tensor, positions: torch.Tensor,
                    lens: torch.Tensor) -> MLACache:
    """Append the new tokens' latent rows (and, with the DSA indexer, its
    keys) at per-sequence offsets ``lens`` (``[B]``), in place; offsets
    ``>= S`` are dropped.  Returns ``cache``."""
    planes, new = [cache.latent], [M.latent_entries(p["mla"], cfg, x_norm,
                                                    positions)]
    if "indexer" in p:
        planes.append(cache.ikeys)
        new.append(M.indexer_keys(p["indexer"], x_norm))
    _append_at(planes, new, lens)
    return cache


def mla_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, mode: str,
              cache: MLACache | None = None,
              lens: torch.Tensor | None = None, moe: bool = False,
              train: bool = False, use_kernel: bool | None = None):
    """Returns ``(y, new_cache, moe_aux | None)``.

    ``mode``: ``"decode"`` appends to ``cache`` in place at ``lens``, then
    attends over it (with the indexer :func:`~repro_torch.models.mla
    .sparse_mla_decode`, else :func:`mla_dense_decode`); ``"prefill"``
    returns a new cache (:func:`~repro_torch.models.mla
    .mla_prefill_attend`; without an indexer its ``ikeys`` plane is
    ``[B,S,1]`` zeros, as the reference's); ``"train"`` attends densely.
    ``use_kernel`` picks the kernels or the plain version of decode,
    prefill and the train mode's DSA mask (default: the kernels on CUDA).
    The MoE statistics come back with ``train``."""
    pi = p.get("indexer")
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        # append first so new tokens attend to themselves
        cache = mla_write_cache(cfg, p, cache, h, positions, lens)
        new_len = lens + h.shape[1]
        if pi is not None:
            attn_out, _ = M.sparse_mla_decode(
                p["mla"], pi, cfg, h, positions, cache.latent, cache.ikeys,
                new_len, use_kernel=use_kernel)
        else:
            attn_out = mla_dense_decode(p, cfg, h, positions, cache,
                                        new_len, use_kernel=use_kernel)
    elif mode == "prefill":
        attn_out, lat, ikeys = M.mla_prefill_attend(
            p["mla"], pi, cfg, h, positions, use_kernel=use_kernel)
        if ikeys is None:
            ikeys = lat.new_zeros(lat.shape[:2] + (1,))
        cache = MLACache(lat, ikeys)
    elif mode == "train":
        attn_out = M.mla_train_attend(p["mla"], pi, cfg, h, positions,
                                      use_kernel=use_kernel)
    else:
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    x = x + attn_out
    f, aux = ffn(p, cfg, x, moe, train)
    return x + f, cache, aux


def mla_dense_decode(p: dict, cfg: ArchConfig, h: torch.Tensor,
                     positions: torch.Tensor, cache: MLACache,
                     new_len: torch.Tensor, use_kernel: bool | None = None
                     ) -> torch.Tensor:
    """Full (non-sparse) MLA decode over the whole latent cache (the V3
    baseline): the absorbed queries [B,Q,H,576] against every row
    ``< new_len``, shared by the Q queries.  ``use_kernel`` (default: on
    CUDA tensors) takes :func:`~repro_torch.kernels.sparse_mla.ops
    .partial_attend` (at MLA's widths in bf16 the tensor-core kernel,
    split over the cache and merged); otherwise
    :func:`~repro_torch.models.mla.partial_sparse_attend`, the oracle."""
    q = M.absorbed_query(p["mla"], cfg, h, positions)
    S = cache.latent.shape[1]
    valid = torch.arange(S, device=h.device)[None, :] < new_len[:, None]
    if M._use_kernel(use_kernel, h):
        part = local_call(sk_ops.partial_attend, q, cache.latent, valid,
                          M.mla_scale(cfg), cfg.mla.kv_lora_rank)
    else:
        part = M.partial_sparse_attend(q, cache.latent, valid, cfg)
    return M.output_proj(p["mla"], cfg, M.finalize_partial(part, h.dtype))


# ---------------------------------------------------------------------------
# SSM (Mamba2) block
# ---------------------------------------------------------------------------

def ssm_block_def(cfg: ArchConfig) -> dict:
    """One SSM layer's definitions: its pre-norm and a Mamba2 mixer."""
    return {"ln": _norm(cfg.d_model, cfg.param_dtype),
            "ssm": SSM.ssm_def(cfg)}


def ssm_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *, mode: str,
              state: SSM.SSMState | None = None):
    """``x + mixer(rmsnorm(x))``: returns ``(y, state)``
    (:func:`~repro_torch.models.ssm.ssm_forward`; a decode updates
    ``state`` in place)."""
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, st = SSM.ssm_forward(p["ssm"], cfg, h, state, mode=mode)
    return x + y, st


def ffn(p: dict, cfg: ArchConfig, x: torch.Tensor, moe: bool,
        train: bool = False):
    """The block's FFN on the residual stream: ``(ln2 -> dense MLP or MoE,
    moe_aux | None)``; the MoE statistics only with ``train``."""
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if not moe:
        return L.mlp(p["ffn"], h2, cfg.act), None
    if train:
        return MoE.moe_apply(p["ffn"], cfg, h2, train=True)
    return MoE.moe_apply(p["ffn"], cfg, h2), None
