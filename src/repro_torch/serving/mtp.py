"""Multi-Token Prediction speculative decode (counterpart of
``repro.serving.mtp``; DeepSeek-V3's MTP modules).

Draft: MTP module ``k`` predicts the token after the previous draft from
the backbone's post-final-norm hidden and that draft's embedding,

    h_k = Block_k( [ RMSNorm(h_{k-1}) ; RMSNorm(Emb(tok_k)) ] @ W_proj )

through the block's FFN only (position-local, as the reference: the
verify pass is the full model, so acceptance stays exact), then the
unembed and a greedy argmax.

Verify: one ``ess_decode`` step at Q = depth + 1 scores every draft; a
draft is accepted while it equals the model's own argmax (``cumprod`` of
the matches); the rejected positions roll back in place: ``lens``
shrinks, every pool drops its entries beyond (``invalidate_beyond``) and
a pipelined round's slab cancels its staged ids beyond.  Everything is
sync-free, so the round runs inside a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.serving.sampling import greedy


def _module(tree: dict, k: int) -> dict:
    return {n: _module(v, k) if isinstance(v, dict) else v[k]
            for n, v in tree.items()}


def mtp_draft(params: dict, cfg: ArchConfig, hidden_last: torch.Tensor,
              first_tok: torch.Tensor, *, depth: Optional[int] = None
              ) -> torch.Tensor:
    """hidden_last ``[B,d]`` (post-final-norm, at the last accepted
    position), first_tok ``[B]`` (the token just emitted) -> drafts
    ``[B, depth]`` int64 (``depth`` defaults to ``cfg.mtp_depth``).  At
    a MoE config the block's FFN is the MoE over the ``B`` draft tokens,
    with its capacity and token-major drops."""
    depth = cfg.mtp_depth if depth is None else depth
    if depth > cfg.mtp_depth:
        raise ValueError(f"draft depth {depth} > cfg.mtp_depth "
                         f"{cfg.mtp_depth} stacked MTP modules")
    head_w = params.get("unembed", params["embed"])
    h, tok = hidden_last, first_tok
    drafts = []
    for k in range(depth):
        mp = _module(params["mtp"], k)
        e = L.embed(params["embed"], tok).to(h.dtype)
        z = torch.cat([L.rmsnorm(mp["ln_h"], h, cfg.norm_eps),
                       L.rmsnorm(mp["ln_e"], e, cfg.norm_eps)], dim=-1)
        h = z @ mp["proj"]
        blk = mp["block"]
        h2 = L.rmsnorm(blk["ln2"], h, cfg.norm_eps)
        if "router" in blk["ffn"]:
            f = MoE.moe_apply(blk["ffn"], cfg, h2[:, None])[:, 0]
        else:
            f = L.mlp(blk["ffn"], h2, cfg.act)
        h = h + f
        tok = greedy(L.unembed(head_w, h))
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


class SpecOut(NamedTuple):
    """One speculative round's result."""
    tokens: torch.Tensor      # [B, depth+1] the model's argmax per position
    n_accepted: torch.Tensor  # [B] tokens emitted (accepted drafts + bonus)
    caches: object            # the caches, lens rolled back in place
    hidden: torch.Tensor      # [B, d] hidden at the last accepted position
    logits: torch.Tensor      # [B, depth+1, V] verify logits
    stats: dict               # the verify step's stats


def speculative_step(params: dict, cfg: ArchConfig, caches,
                     prev_tok: torch.Tensor, prev_hidden: torch.Tensor, *,
                     slot_mask: Optional[torch.Tensor] = None,
                     sample_mask: Optional[torch.Tensor] = None,
                     depth: Optional[int] = None,
                     decode_fn: Optional[Callable] = None,
                     staged_ids: Optional[torch.Tensor] = None) -> SpecOut:
    """One MTP speculative round over the slot batch: the drafts, then the
    verify step at Q = depth + 1, ``decode_fn(params, cfg, tokens,
    positions, caches) -> DecodeOut`` (the reference's seam; by default
    ``ess_decode`` gated on ``slot_mask``, and the serve round passes its
    TBO-composed step).

    * ``slot_mask [B]`` gates the verify step and the rollback: a frozen
      slot appends nothing, and the unconditional correction would shrink
      it.
    * ``sample_mask [B]`` force-rejects the drafts of sampling slots
      (``n_acc = 0``): the caller draws their token from
      ``logits[:, 0]``, the exact Q = 1 distribution.

    ``caches.lens`` is corrected in place, then every pool drops its
    entries at rejected positions (after the verify step's admit and
    tick, as ``invalidate_beyond`` requires), and ``staged_ids [L,B,P]``
    (a pipelined round's slab, which the verify step has just planned)
    cancels its ids at those positions: their tier rows hold rejected
    drafts, which the next round's appends overwrite."""
    from repro_torch.serving import engine as E   # engine imports this
    B = prev_tok.shape[0]
    depth = cfg.mtp_depth if depth is None else depth
    drafts = mtp_draft(params, cfg, prev_hidden, prev_tok, depth=depth)
    q_tokens = torch.cat([prev_tok[:, None], drafts], dim=1)      # [B,Q]
    positions = caches.lens[:, None] + torch.arange(
        depth + 1, device=prev_tok.device)[None]

    if decode_fn is None:
        def decode_fn(p_, c_, t_, po_, ca_):
            return E.ess_decode(p_, c_, t_, po_, ca_, slot_mask=slot_mask)
    out = decode_fn(params, cfg, q_tokens, positions, caches)
    model_next = greedy(out.logits)                                # [B,Q]
    match = drafts == model_next[:, :depth]
    n_acc = match.long().cumprod(dim=1).sum(dim=1)                 # [B]
    if sample_mask is not None:
        n_acc = torch.where(sample_mask, 0, n_acc)

    live = torch.ones((B,), dtype=torch.bool, device=prev_tok.device) \
        if slot_mask is None else slot_mask
    lens_after = out.caches.lens
    corrected = torch.where(live, lens_after - depth + n_acc, lens_after)
    caches.lens.copy_(corrected)
    for p in out.caches.pools:
        LP.invalidate_beyond(p, caches.lens)
    if staged_ids is not None:
        staged_ids.copy_(torch.where(staged_ids < caches.lens[None, :, None],
                                     staged_ids, -1))

    hid = out.stats["hidden"]                                      # [B,Q,d]
    last = n_acc.clamp(0, depth)[:, None, None].expand(B, 1, hid.shape[-1])
    hidden = hid.gather(1, last)[:, 0]
    return SpecOut(model_next, n_acc + 1, out.caches._replace(
        lens=caches.lens), hidden, out.logits, out.stats)
