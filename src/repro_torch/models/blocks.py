"""The MLA + DSA transformer block of the monolithic model (counterpart of
the MLA part of ``repro.models.blocks``): MLA attention with the DSA
indexer, then the dense or MoE FFN, pre-norms and residuals.

The cache of one layer is an :class:`MLACache` of ``[B,S,...]`` planes.  A
decode step appends its tokens' rows **in place** (a view of the model's
stacked ``[L,B,S,...]`` cache is written through), with no host sync, so
the step can be replayed as a CUDA graph; a prefill returns new planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lru_pool import put_drop
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as MoE


class MLACache(NamedTuple):
    latent: torch.Tensor     # [B, S, latent_dim]
    ikeys: torch.Tensor      # [B, S, index_dim]


def mla_write_cache(cfg: ArchConfig, p: dict, cache: MLACache,
                    x_norm: torch.Tensor, positions: torch.Tensor,
                    lens: torch.Tensor) -> MLACache:
    """Append the new tokens' latent rows and indexer keys at per-sequence
    offsets ``lens`` (``[B]``), in place; offsets ``>= S`` are dropped
    (the reference's ``.at[...].set(mode="drop")``).  Returns ``cache``."""
    new_lat = M.latent_entries(p["mla"], cfg, x_norm, positions)
    Q, S = new_lat.shape[1], cache.latent.shape[1]
    idx = lens[:, None] + torch.arange(Q, device=lens.device)[None, :]
    keep = idx < S
    idx = idx.clamp(0, S - 1)
    put_drop(cache.latent, idx, new_lat, keep)
    put_drop(cache.ikeys, idx, M.indexer_keys(p["indexer"], x_norm), keep)
    return cache


def _no_indexer() -> NotImplementedError:
    return NotImplementedError(
        "MLA without the DSA indexer (mla_dense_decode, the DeepSeek-V3 "
        "branch) is not ported yet: ROADMAP Queue 1 item 6")


def mla_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, mode: str,
              cache: MLACache | None = None,
              lens: torch.Tensor | None = None, moe: bool = False,
              train: bool = False, use_kernel: bool | None = None):
    """Returns ``(y, new_cache, moe_aux | None)``.

    ``mode``: ``"decode"`` appends to ``cache`` in place at ``lens``, then
    attends over it (:func:`~repro_torch.models.mla.sparse_mla_decode`);
    ``"prefill"`` returns a new cache (:func:`~repro_torch.models.mla
    .mla_prefill_attend`); ``"train"`` attends densely.  ``use_kernel``
    picks the kernels or the plain version of decode and prefill (default:
    the kernels on CUDA).  The MoE statistics come back with ``train``."""
    pi = p.get("indexer")
    if pi is None:
        raise _no_indexer()
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        # append first so new tokens attend to themselves
        cache = mla_write_cache(cfg, p, cache, h, positions, lens)
        attn_out, _ = M.sparse_mla_decode(
            p["mla"], pi, cfg, h, positions, cache.latent, cache.ikeys,
            lens + h.shape[1], use_kernel=use_kernel)
    elif mode == "prefill":
        attn_out, lat, ikeys = M.mla_prefill_attend(
            p["mla"], pi, cfg, h, positions, use_kernel=use_kernel)
        cache = MLACache(lat, ikeys)
    elif mode == "train":
        attn_out = M.mla_train_attend(p["mla"], pi, cfg, h, positions)
    else:
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    x = x + attn_out
    f, aux = ffn(p, cfg, x, moe, train)
    return x + f, cache, aux


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
