"""ESS serving steps for DSA+MLA models (counterpart of the synchronous
path of ``repro.serving.engine``, with a bf16 or a quantized int8 / fp8
host tier).

* :func:`ess_decode` — one Q-token decode step over every layer: append the
  indexer key (device) and the latent row (host tier, UVA write), run ESS
  sparse attention (indexer top-k, pool lookup, UVA miss fetch, Attn0 ||
  Attn1, exact merge, LRU admit), then the dense or MoE FFN.
* :func:`ess_prefill_chunk` / :func:`ess_prefill` — chunked prefill into the
  paged host tier, then the LRU warmup: the last ``W`` prompt tokens are
  replayed as single-token decode steps with the full miss envelope.
* :func:`generate_batch` — a fixed batch of equal-length prompts: prefill,
  then greedy Q=1 decode rounds.

Caches are updated in place (host tier, indexer cache, pools); each step
still returns an ``ESSCaches`` with the new ``lens``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache import latent_cache as LC
from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.core.overlap import (ESSLayerState, _attend_rows,
                                      ess_sparse_attention)
from repro_torch.distributed import compression as cmp
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as MoE


class DecodeOut(NamedTuple):
    logits: torch.Tensor
    caches: Any
    stats: dict


def _layer_params(params: dict, cfg: ArchConfig, layer: int):
    """(parameter views of one layer, is_moe)."""
    nd = cfg.moe.first_dense_layers if cfg.moe else 0

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    if layer < nd:
        return pick(params["dense_layers"], layer), False
    return pick(params["layers"], layer - nd), cfg.moe is not None


def _overlap_for_layer(cfg: ArchConfig, layer: int,
                       layerwise: tuple[str, ...] | None) -> str:
    if cfg.ess.overlap == "layerwise":
        return layerwise[layer] if layerwise is not None else "da"
    return cfg.ess.overlap


def _ffn(lp: dict, cfg: ArchConfig, x: torch.Tensor, is_moe: bool
         ) -> torch.Tensor:
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if is_moe:
        return MoE.moe_apply(lp["ffn"], cfg, h2)
    return L.mlp(lp["ffn"], h2, cfg.act)


def _append_ikeys(ik: torch.Tensor, widx: torch.Tensor, new_ik: torch.Tensor
                  ) -> None:
    """In place ``ik[b, widx[b,q]] = new_ik[b,q]``; -1 / out-of-range drop."""
    LP.put_drop(ik, widx.clamp(0, ik.shape[1] - 1), new_ik,
                (widx >= 0) & (widx < ik.shape[1]))


def ess_decode(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               positions: torch.Tensor, caches: LC.ESSCaches, *,
               layerwise_policy: tuple[str, ...] | None = None,
               slot_mask: torch.Tensor | None = None) -> DecodeOut:
    """tokens [B,Q] -> logits [B,Q,V] fp32.  Q>1 = draft verification.

    ``slot_mask`` [B] marks live slots; masked slots write nothing, take no
    pool lookups or admissions and keep their ``lens``.  Updates the caches
    in place; ``stats`` holds per-slot ``hits`` / ``misses`` /
    ``overflow`` summed over layers, and ``hidden``."""
    B, Q = tokens.shape
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    lens = caches.lens
    live = torch.ones((B,), dtype=torch.bool, device=tokens.device) \
        if slot_mask is None else slot_mask
    new_lens = lens + Q * live.long()
    widx = torch.where(live[:, None],
                       lens[:, None] + torch.arange(Q, device=lens.device),
                       -1)                                        # [B,Q]
    attn_lens = widx + 1        # query q sees positions <= its own
    hits = misses = ovf = torch.zeros((B,), dtype=torch.int64,
                                      device=tokens.device)

    for layer in range(cfg.num_layers):
        lp, is_moe = _layer_params(params, cfg, layer)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        # append: indexer key (device) + latent row (host tier, UVA write
        # on this stream, so this layer's fetch below sees it; a quantized
        # tier quantizes the row first)
        _append_ikeys(caches.ikeys[layer], widx,
                      M.indexer_keys(lp["indexer"], h))
        new_lat = M.latent_entries(lp["mla"], cfg, h, positions)
        offload.scatter_tier_rows(caches.host_latent, caches.host_scales,
                                  widx, new_lat, slot_mask=None, layer=layer,
                                  block_table=caches.block_tables)
        st = ESSLayerState(caches.pools[layer], caches.host_latent, layer,
                           block_table=caches.block_tables,
                           host_scales=caches.host_scales)
        attn, st2, stats = ess_sparse_attention(
            lp["mla"], lp["indexer"], cfg, h, positions, st,
            caches.ikeys[layer], attn_lens,
            overlap=_overlap_for_layer(cfg, layer, layerwise_policy),
            slot_mask=live)
        caches.pools[layer] = st2.pool
        x = x + attn
        x = x + _ffn(lp, cfg, x, is_moe)
        hits = hits + stats.hits
        misses = misses + stats.misses
        ovf = ovf + stats.overflow

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params.get("unembed", params["embed"]), x)
    stats_out = {"hits": hits, "misses": misses, "overflow": ovf,
                 "hidden": x}
    return DecodeOut(logits, caches._replace(lens=new_lens), stats_out)


def ess_prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, caches: LC.ESSCaches, *,
                      want_logits: bool = True
                      ) -> tuple[Optional[torch.Tensor], LC.ESSCaches]:
    """One chunked-prefill step: ``tokens [B,C]`` continue every sequence
    at ``caches.lens``; their latents land in the mapped host pages (one
    stacked write per plane after the layer loop) and their indexer keys
    in the device cache.  (The reference's per-slot ``slot`` and padded
    ``n_valid`` forms serve the continuous-batching loop, a later slice.)

    Attention is the exact causal DSA selection: per-query top-k over the
    sequence's indexer cache, prior-context rows fetched from the host tier,
    intra-chunk rows from the chunk itself, one sparse-MLA partial per
    query (fp32 math on the rows' own dtype: bf16 rows are not copied to
    fp32 first).  The pool is untouched.  A quantized tier quantizes each
    layer's chunk rows once: intra-chunk queries read ``dequant(q, s)``,
    the value any later query reads back from the tier, and the stacked
    writes after the layer loop commit the same ``(q, s)``.  Returns
    ``(logits | None, caches)``."""
    B, C = tokens.shape
    dev = tokens.device
    start = caches.lens                                           # [B]
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    widx = start[:, None] + torch.arange(C, device=dev)[None, :]  # [B,C]
    host, host_scales = caches.host_latent, caches.host_scales
    S = caches.ikeys[0].shape[1]
    K = min(cfg.dsa.index_topk, S)
    causal = torch.arange(S, device=dev)[None, None, :] <= widx[:, :, None]
    bi = torch.arange(B, device=dev)[:, None, None]
    lat_stack, scale_stack = [], []

    for layer in range(cfg.num_layers):
        lp, is_moe = _layer_params(params, cfg, layer)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        ik = caches.ikeys[layer]
        _append_ikeys(ik, widx, M.indexer_keys(lp["indexer"], h))
        new_lat = M.latent_entries(lp["mla"], cfg, h, positions)
        if host_scales is None:
            new_lat = new_lat.to(host.dtype)
            lat_stack.append(new_lat)
        else:
            q_lat, s_lat = cmp.quantize_rows(new_lat, host.dtype)
            lat_stack.append(q_lat)
            scale_stack.append(s_lat)
            new_lat = cmp.dequantize_rows(q_lat, s_lat, cfg.param_dtype)

        iq = M.indexer_query(lp["indexer"], h)
        sc = M.indexer_scores(iq, ik, causal)                # [B,C,S]
        ids = M.topk_ids(sc, K, causal)                           # [B,C,K]
        req_valid = causal.gather(2, ids)
        # prior context from the host tier, intra-chunk rows from the chunk
        local = ids >= start[:, None, None]
        prior_ids = torch.where(local, -1, ids)
        rows_h = offload.gather_tier_rows(
            host, host_scales, prior_ids.reshape(B, C * K),
            layer=layer, block_table=caches.block_tables,
            out_dtype=new_lat.dtype).view(B, C, K, -1)
        loc = (ids - start[:, None, None]).clamp(0, C - 1)
        rows = torch.where(local[..., None], new_lat[bi, loc], rows_h)
        del rows_h
        q_comb = M.absorbed_query(lp["mla"], cfg, h, positions)
        # q and rows in their own dtype: the kernels (and the plain
        # version) widen to fp32 inside, as the reference's fp32 prefill
        part = _attend_rows(q_comb, rows, req_valid, cfg)
        del rows
        x = x + M.output_proj(lp["mla"], cfg,
                              M.finalize_partial(part, x.dtype))
        x = x + _ffn(lp, cfg, x, is_moe)

    # one stacked write per plane for the whole chunk (all layers)
    offload.host_scatter_rows_stacked(
        host, widx, torch.stack(lat_stack), slot_mask=None,
        block_table=caches.block_tables)
    if host_scales is not None:
        offload.host_scatter_rows_stacked(
            host_scales, widx, torch.stack(scale_stack), slot_mask=None,
            block_table=caches.block_tables)
    logits = None
    if want_logits:
        xf = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params.get("unembed", params["embed"]), xf)
    return logits, caches._replace(lens=start + C)


def ess_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                positions: torch.Tensor, max_seq: int, *,
                prefill_chunk: Optional[int] = None,
                last_logits_only: bool = False
                ) -> tuple[torch.Tensor, LC.ESSCaches]:
    """Prefill + LRU warmup (paper section 3.2) on ``tokens.device``.

    The first ``S - W`` tokens stream through :func:`ess_prefill_chunk` in
    ``prefill_chunk``-token chunks (default ``min(S - W, 512)``); the last
    ``W = warmup_windows`` tokens are replayed as single-token
    :func:`ess_decode` steps at ``max_miss_ratio = 1.0``, which LRU-admits
    each window's true top-k.  Returns ``(logits [B,S,V], caches)``, or
    only the last position's logits ``[B,1,V]`` with ``last_logits_only``
    (full-width prompts: ``[B,S,V]`` fp32 would not fit the card)."""
    B, S = tokens.shape
    W = min(cfg.ess.warmup_windows, S - 1)
    Sp = S - W
    caches = LC.init_ess_caches(cfg, B, max_seq, cfg.param_dtype,
                                device=tokens.device)
    C = min(Sp, 512) if prefill_chunk is None else max(1, prefill_chunk)
    parts = []
    for c0 in range(0, Sp, C):
        ck = min(C, Sp - c0)
        last = c0 + ck == Sp
        lg, caches = ess_prefill_chunk(
            params, cfg, tokens[:, c0:c0 + ck], positions[:, c0:c0 + ck],
            caches, want_logits=not last_logits_only or (last and W == 0))
        if lg is not None:
            parts.append(lg[:, -1:] if last_logits_only else lg)
    if W > 0:
        cfg_x = dataclasses.replace(
            cfg, ess=dataclasses.replace(cfg.ess, max_miss_ratio=1.0))
        for w in range(Sp, S):
            o = ess_decode(params, cfg_x, tokens[:, w:w + 1],
                           positions[:, w:w + 1], caches)
            caches = o.caches
            if not last_logits_only or w == S - 1:
                parts.append(o.logits)
    logits = parts[-1] if last_logits_only else torch.cat(parts, dim=1)
    return logits, caches


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray           # [B, max_new_tokens] greedy stream
    hits: np.ndarray             # [R, B] pool hits per decode round
    misses: np.ndarray           # [R, B] rows fetched from the host tier
    overflow: np.ndarray         # [R, B] misses past the envelope
    round_s: list                # wall seconds of each decode round
    prefill_s: float             # wall seconds of prefill + warmup
    evicted: int                 # pool rows evicted (all layers, slots)
    logits_finite: bool          # every logit of every step was finite
    tier_bytes: int              # host tier bytes (payload + scales)
    miss_bytes: np.ndarray       # [R] bytes fetched from the tier
    caches: Any = None


def generate_batch(params: dict, cfg: ArchConfig, prompts,
                   max_new_tokens: int, max_seq: int, *,
                   prefill_chunk: Optional[int] = None,
                   device=None) -> GenerateResult:
    """Serve a fixed batch of equal-length prompts ([B,S] ints): prefill +
    warmup, then greedy Q=1 decode rounds.  The first new token comes from
    the prefill's last logits, so ``max_new_tokens - 1`` rounds follow.
    The host tier's dtype is ``cfg.ess.host_cache_dtype``.  Runs on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)
    B, S = tokens.shape
    if S + max_new_tokens > max_seq:
        raise ValueError(f"prompt {S} + {max_new_tokens} new > max_seq "
                         f"{max_seq}")
    positions = torch.arange(S, device=dev)[None].expand(B, S)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, caches = ess_prefill(params, cfg, tokens, positions, max_seq,
                                 prefill_chunk=prefill_chunk,
                                 last_logits_only=True)
    finite = torch.isfinite(logits).all()
    tok = logits[:, -1].argmax(-1)
    sync()
    prefill_s = time.perf_counter() - t0

    out, hits, misses, ovf, round_s = [tok], [], [], [], []
    for _ in range(max_new_tokens - 1):
        t0 = time.perf_counter()
        o = ess_decode(params, cfg, tok[:, None], caches.lens[:, None], caches)
        caches = o.caches
        finite = finite & torch.isfinite(o.logits).all()
        tok = o.logits[:, 0].argmax(-1)
        out.append(tok)
        hits.append(o.stats["hits"])
        misses.append(o.stats["misses"])
        ovf.append(o.stats["overflow"])
        sync()
        round_s.append(time.perf_counter() - t0)

    def rounds(xs):
        return (torch.stack(xs).cpu().numpy() if xs
                else np.zeros((0, B), np.int64))
    evicted = int(sum(int(p.evicted.sum()) for p in caches.pools))
    misses, ovf = rounds(misses), rounds(ovf)
    # rows past the miss envelope are dropped, not fetched
    row_bytes = LC.host_row_bytes(cfg, cfg.param_dtype)
    return GenerateResult(
        tokens=torch.stack(out, 1).cpu().numpy(), hits=rounds(hits),
        misses=misses, overflow=ovf, round_s=round_s,
        prefill_s=prefill_s, evicted=evicted,
        logits_finite=bool(finite), tier_bytes=LC.tier_nbytes(caches),
        miss_bytes=(misses - ovf).sum(1) * row_bytes, caches=caches)
