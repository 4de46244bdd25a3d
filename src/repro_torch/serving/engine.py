"""ESS serving steps for DSA+MLA models (counterpart of the synchronous
path of ``repro.serving.engine``, with a bf16 or a quantized int8 / fp8
host tier), and the generic path.

* :func:`generic_prefill` / :func:`generic_decode` — the monolithic model
  (:func:`repro_torch.models.transformer.forward`): the whole latent cache
  in device memory, the baseline ESS is measured against.
* :func:`ess_decode` — one Q-token decode step over every layer: append the
  indexer key (device) and the latent row (host tier, UVA write), run ESS
  sparse attention (indexer top-k, pool lookup, UVA miss fetch, Attn0 ||
  Attn1, exact merge, LRU admit), then the dense or MoE FFN.
* :func:`ess_prefill_chunk` / :func:`ess_prefill` — chunked prefill into the
  paged host tier, then the LRU warmup: the last ``W`` prompt tokens are
  replayed as single-token decode steps with the full miss envelope.
* :func:`generate_batch` — a fixed batch of equal-length prompts: prefill,
  then greedy Q=1 decode rounds.
* :class:`ServeSession` — the continuous-batching serve loop: chunked
  per-slot prefill interleaved with decode rounds (Q = 1, or MTP
  speculative rounds), greedy or sampled requests, slots recycled,
  admission gated in host bytes, each round replayed as a CUDA graph
  (:mod:`repro_torch.serving.step`) with one host fetch per round.

Caches are updated in place (host tier, indexer cache, pools); each step
still returns an ``ESSCaches`` with the new ``lens``.  The steps are free
of host syncs on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device, upload
from repro_torch.cache import latent_cache as LC
from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.core import transfer as TR
from repro_torch.core import warmup as WU
from repro_torch.core.overlap import (ESSLayerState, Fork, _attend_rows,
                                      ess_sparse_attention,
                                      ess_sparse_attention_staged,
                                      side_stream)
from repro_torch.distributed import compression as cmp
from repro_torch.models import blocks as MB
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import transformer as T
from repro_torch.serving import state as ES
from repro_torch.serving import step as SP
from repro_torch.serving.api import TokenEvent
from repro_torch.serving.sampling import greedy, request_key, sample
from repro_torch.serving.scheduler import Request, Scheduler


class DecodeOut(NamedTuple):
    logits: torch.Tensor
    caches: Any
    stats: dict


# ---------------------------------------------------------------------------
# Generic path
# ---------------------------------------------------------------------------

def generic_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, *, device=None, **kw
                    ) -> T.ForwardOut:
    """The monolithic prefill (``forward(mode="prefill")``) on ``device``
    (the card unless ``device="cpu"``): on CUDA the kernel route, by ids
    in query chunks.  ``kw`` goes to ``forward`` (``want_logits``,
    ``use_kernel``)."""
    dev = resolve_device(device)
    return T.forward(params, cfg, tokens.to(dev), positions.to(dev),
                     mode="prefill", **kw)


def generic_decode(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, caches: dict, *, device=None,
                   **kw) -> DecodeOut:
    """One monolithic decode step: tokens [B,Q] at ``caches["lens"]``.

    Updates ``caches`` in place, ``lens`` included, and returns them: no
    host sync and no rebinding, so a CUDA graph captured over one call
    replays the next steps (the indexer top-k, the row gather and the
    sparse-MLA partial on the card)."""
    dev = resolve_device(device)
    out = T.forward(params, cfg, tokens.to(dev), positions.to(dev),
                    mode="decode", caches=caches, **kw)
    caches["lens"].copy_(out.caches["lens"])
    return DecodeOut(out.logits, caches, {})


# ---------------------------------------------------------------------------
# ESS path (DSA + MLA + offload)
# ---------------------------------------------------------------------------

_layer_params = T.layer_params


def _overlap_for_layer(cfg: ArchConfig, layer: int,
                       layerwise: tuple[str, ...] | None) -> str:
    if cfg.ess.overlap == "layerwise":
        return layerwise[layer] if layerwise is not None else "da"
    return cfg.ess.overlap


def _append_ikeys(ik: torch.Tensor, widx: torch.Tensor, new_ik: torch.Tensor
                  ) -> None:
    """In place ``ik[b, widx[b,q]] = new_ik[b,q]``; -1 / out-of-range drop."""
    LP.put_drop(ik, widx.clamp(0, ik.shape[1] - 1), new_ik,
                (widx >= 0) & (widx < ik.shape[1]))


def _commit_and_plan(cfg: ArchConfig, caches: LC.ESSCaches, staged: tuple,
                     widx: torch.Tensor, live: torch.Tensor, lat_stack: list,
                     scale_stack: list, sigs: list, misses: torch.Tensor,
                     pf_h: torch.Tensor,
                     fetch_stream: torch.cuda.Stream | None):
    """The pipelined round's commit and plan stages, after its layer loop.

    Commit: every layer's appended rows (a quantized tier's ``(q, s)``,
    quantized once in the loop) go to the tier in one stacked write per
    plane.  Plan: the layers' last-query scores, ranked in one batched
    stable top-k over ``[L*B, S]``; ids already staged are kept with their
    rows (the tier is append-only below the truncation edges, which cancel
    what they invalidate); only new ids are gathered, forked onto
    ``fetch_stream`` after the commit's write, so that the gather reads the
    rows appended this round.  The reference plans only if the round missed
    (``lax.cond``); here both sides run and ``torch.where`` keeps the old
    slab when none did (the gather's ids are then all -1 and read nothing).

    The new ids are written into the slab at once; returns ``(land,
    pf_wasted [B])``: ``land()`` joins the gather and copies the new rows
    (and scales) into the slab, in place."""
    old_ids, old_rows, old_scales = staged
    bt = caches.block_tables
    offload.scatter_from_slab(
        caches.host_latent, caches.host_scales, widx, torch.stack(lat_stack),
        torch.stack(scale_stack) if scale_stack else None, slot_mask=None,
        block_table=bt)
    Lh, B, P = old_ids.shape
    D = old_rows.shape[-1]
    pf_w = (old_ids >= 0).sum((0, 2)).int() * live.int() - pf_h
    pred = TR.plan_prefetch(
        torch.stack([s[0] for s in sigs]).reshape(Lh * B, -1),
        sigs[0][1].repeat(Lh),
        torch.stack([s[2] for s in sigs]).reshape(Lh * B, -1),
        live.repeat(Lh), cfg.dsa.index_topk, P).view(Lh, B, P)
    go = (misses > 0).any()
    eq = (pred[..., None] == old_ids[..., None, :]) \
        & (old_ids >= 0)[..., None, :] & (pred >= 0)[..., None]   # [L,B,P,P]
    have = eq.any(-1)
    src = TR.first_true(eq)
    rows_b = TR.raw_bytes(old_rows)
    reused = rows_b.gather(2, src[..., None].expand(Lh, B, P, D))
    reused_s = None if old_scales is None else old_scales.gather(
        2, src[..., None])
    new_ids = torch.where(go & ~have, pred, -1)
    fresh = torch.empty((Lh, B, P, D), dtype=old_rows.dtype,
                        device=old_rows.device)
    fresh_s = None if old_scales is None else torch.empty(
        (Lh, B, P, 1), dtype=old_scales.dtype, device=old_scales.device)
    with Fork(fetch_stream, new_ids, fresh,
              *([] if fresh_s is None else [fresh_s])) as fork:
        offload.gather_into_slab(caches.host_latent, caches.host_scales,
                                 new_ids, slot_mask=None, block_table=bt,
                                 out=fresh, out_scales=fresh_s)
    old_ids.copy_(torch.where(go, pred, old_ids))

    def land() -> None:
        fork.join()
        keep = have[..., None]
        rows_b.copy_(torch.where(go, torch.where(
            keep, reused, TR.raw_bytes(fresh)), rows_b))
        if old_scales is not None:
            old_scales.copy_(torch.where(
                go, torch.where(keep, reused_s, fresh_s), old_scales))
    return land, pf_w


def ess_decode(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               positions: torch.Tensor, caches: LC.ESSCaches, *,
               layerwise_policy: tuple[str, ...] | None = None,
               slot_mask: torch.Tensor | None = None,
               fetch_stream: torch.cuda.Stream | None = None,
               staged: tuple | None = None,
               land_slab: bool = True) -> DecodeOut:
    """tokens [B,Q] -> logits [B,Q,V] fp32.  Q>1 = draft verification.

    ``slot_mask`` [B] marks live slots; masked slots write nothing, take no
    pool lookups or admissions and keep their ``lens``.  Each layer's
    overlap mode is ``cfg.ess.overlap``, or, under ``"layerwise"``, its
    entry of ``layerwise_policy`` (DA without one, as the reference's
    sessions run it); ``fetch_stream`` carries the DA / DBA miss fetches
    (:mod:`repro_torch.core.overlap`).  Updates the caches in place;
    ``stats`` holds per-slot ``hits`` / ``misses`` / ``overflow`` summed
    over layers, and ``hidden``.

    ``staged = (ids [L,B,P], rows [L,B,P,D], scales [L,B,P,1] | None)``,
    the slab's persistent tensors (:mod:`repro_torch.core.transfer`),
    makes this the **pipelined** round: each layer sources its misses from
    its own appended rows, the slab and a fallback gather
    (:func:`~repro_torch.core.overlap.ess_sparse_attention_staged`); the
    layers' tier writes wait for one stacked commit after the loop; the
    plan then stages the next round's rows into the slab, in place
    (:func:`_commit_and_plan`), its gather on ``fetch_stream`` beside the
    final norm and the unembedding.  ``land_slab=False`` leaves the
    gather's join and the rows' copy to the caller, as
    ``stats["land_slab"]()`` (the serve round runs the token selection
    first).  ``stats`` gains the prefetch counters ``pf_hits`` /
    ``pf_misses`` / ``pf_wasted`` ``[B]`` int32.  The streams equal the
    synchronous round's."""
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
    # the pipelined round: appended rows held for the commit, the layers'
    # plan signals, the prefetch counters
    lat_stack, scale_stack, sigs = [], [], []
    pf_h = pf_m = torch.zeros((B,), dtype=torch.int32, device=tokens.device)

    for layer in range(cfg.num_layers):
        lp, is_moe = _layer_params(params, cfg, layer)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        # append: indexer key (device) + latent row (host tier, UVA write
        # on this stream, so this layer's fetch below sees it; a quantized
        # tier quantizes the row first)
        _append_ikeys(caches.ikeys[layer], widx,
                      M.indexer_keys(lp["indexer"], h))
        new_lat = M.latent_entries(lp["mla"], cfg, h, positions)
        if staged is None:
            offload.scatter_tier_rows(caches.host_latent, caches.host_scales,
                                      widx, new_lat, slot_mask=None,
                                      layer=layer,
                                      block_table=caches.block_tables)
        elif caches.host_scales is None:
            own_rows = new_lat.to(caches.host_latent.dtype)
            lat_stack.append(own_rows)
        else:
            # quantized once: the commit writes this (q, s) and the round's
            # own misses read dequant(q, s), what the tier would give back
            q_lat, s_lat = cmp.quantize_rows(new_lat,
                                             caches.host_latent.dtype)
            lat_stack.append(q_lat)
            scale_stack.append(s_lat)
            own_rows = cmp.dequantize_rows(q_lat, s_lat, cfg.param_dtype)
        st = ESSLayerState(caches.pools[layer], caches.host_latent, layer,
                           block_table=caches.block_tables,
                           host_scales=caches.host_scales)
        ov = _overlap_for_layer(cfg, layer, layerwise_policy)
        if staged is None:
            attn, st2, stats = ess_sparse_attention(
                lp["mla"], lp["indexer"], cfg, h, positions, st,
                caches.ikeys[layer], attn_lens, overlap=ov, slot_mask=live,
                fetch_stream=fetch_stream)
        else:
            attn, st2, stats, sig, pf = ess_sparse_attention_staged(
                lp["mla"], lp["indexer"], cfg, h, positions, st,
                caches.ikeys[layer], attn_lens, new_rows=own_rows, widx=widx,
                staged_ids_l=staged[0][layer],
                staged_rows_l=staged[1][layer],
                staged_scales_l=None if staged[2] is None
                else staged[2][layer], overlap=ov, slot_mask=live,
                fetch_stream=fetch_stream)
            sigs.append(sig)
            pf_h, pf_m = pf_h + pf[0], pf_m + pf[1]
        caches.pools[layer] = st2.pool
        x = x + attn
        x = x + MB.ffn(lp, cfg, x, is_moe)[0]
        hits = hits + stats.hits
        misses = misses + stats.misses
        ovf = ovf + stats.overflow

    if staged is not None:
        land, pf_w = _commit_and_plan(cfg, caches, staged, widx, live,
                                      lat_stack, scale_stack, sigs, misses,
                                      pf_h, fetch_stream)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params.get("unembed", params["embed"]), x)
    stats_out = {"hits": hits, "misses": misses, "overflow": ovf,
                 "hidden": x}
    if staged is not None:
        stats_out.update(pf_hits=pf_h, pf_misses=pf_m, pf_wasted=pf_w)
        if land_slab:
            land()
        else:
            stats_out["land_slab"] = land
    return DecodeOut(logits, caches._replace(lens=new_lens), stats_out)


def ess_prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, caches: LC.ESSCaches, *,
                      slot: Optional[int] = None, want_logits: bool = True,
                      collect_tail: int = 0, n_valid: Optional[int] = None
                      ) -> tuple[Optional[torch.Tensor], LC.ESSCaches, tuple,
                                 Optional[torch.Tensor]]:
    """One chunked-prefill step: ``tokens [Bc,C]`` continue the sequence(s)
    at ``caches.lens``; their latents land in the mapped host pages (one
    stacked write per plane after the layer loop) and their indexer keys
    in the device cache.

    * ``slot`` (a Python int) restricts the step to one decode slot of a
      shared continuous-batching cache (``Bc = 1``); ``None`` runs every
      row (the fixed-batch :func:`ess_prefill`).
    * ``n_valid`` (a Python int) marks the first ``n_valid`` positions as
      real and the rest as the padding of a shape-bucketed ragged last
      chunk.  Pad positions write nothing (``widx = -1``: indexer keys and
      tier rows dropped), no valid query attends to them, and ``lens``
      advance by ``n_valid``.  Their own outputs are discarded.
    * Attention is the exact causal DSA selection: per-query top-k over the
      slot's indexer cache, prior-context rows fetched from the host tier,
      intra-chunk rows from the chunk itself, one sparse-MLA partial per
      query (fp32 math on the rows' own dtype: bf16 rows are not copied to
      fp32 first).  The pool is untouched.  A quantized tier quantizes
      each layer's chunk rows once: intra-chunk queries read
      ``dequant(q, s)``, the value any later query reads back from the
      tier, and the stacked writes after the layer loop commit the same
      ``(q, s)``.

    Sync-free: ``slot`` and ``n_valid`` stay host ints.  Returns
    ``(logits | None, caches, tails, hidden_last)``: ``tails`` holds each
    layer's post-ln1 hidden states of the last ``collect_tail`` positions
    (the LRU warmup's input) and ``hidden_last`` the post-final-norm hidden
    at the last valid position (``None`` unless ``want_logits``)."""
    b0, Bc = (0, tokens.shape[0]) if slot is None else (slot, 1)
    C = tokens.shape[1]
    dev = tokens.device
    nv = C if n_valid is None else n_valid
    start = caches.lens[b0:b0 + Bc]                               # [Bc]
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    cpos = torch.arange(C, device=dev)
    widx = torch.where(cpos[None, :] < nv, start[:, None] + cpos[None, :],
                       -1)                                        # [Bc,C]
    host, host_scales = caches.host_latent, caches.host_scales
    bt = caches.block_tables
    S = caches.ikeys[0].shape[1]
    K = min(cfg.dsa.index_topk, S)
    causal = torch.arange(S, device=dev)[None, None, :] <= widx[:, :, None]
    bi = torch.arange(Bc, device=dev)[:, None, None]
    lat_stack, scale_stack, tails = [], [], []

    for layer in range(cfg.num_layers):
        lp, is_moe = _layer_params(params, cfg, layer)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if collect_tail:
            tails.append(h[:, -collect_tail:])
        ik = caches.ikeys[layer][b0:b0 + Bc]          # a view: in place
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
        sc = M.indexer_scores(iq, ik, causal)                # [Bc,C,S]
        ids = M.topk_ids(sc, K, causal)                           # [Bc,C,K]
        req_valid = causal.gather(2, ids)
        # prior context from the host tier, intra-chunk rows from the chunk
        local = ids >= start[:, None, None]
        prior_ids = torch.where(local, -1, ids)
        rows_h = offload.gather_tier_rows(
            host, host_scales, prior_ids.reshape(Bc, C * K), layer=layer,
            batch_offset=b0, block_table=bt,
            out_dtype=new_lat.dtype).view(Bc, C, K, -1)
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
        x = x + MB.ffn(lp, cfg, x, is_moe)[0]

    # one stacked write per plane for the whole chunk (all layers; pad
    # rows carry widx == -1 and drop)
    offload.host_scatter_rows_stacked(
        host, widx, torch.stack(lat_stack), slot_mask=None,
        batch_offset=b0, block_table=bt)
    if host_scales is not None:
        offload.host_scatter_rows_stacked(
            host_scales, widx, torch.stack(scale_stack), slot_mask=None,
            batch_offset=b0, block_table=bt)
    new_lens = caches.lens.clone()
    new_lens[b0:b0 + Bc].add_(nv)
    logits = hidden_last = None
    if want_logits:
        xf = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params.get("unembed", params["embed"]), xf)
        hidden_last = xf[:, max(nv - 1, 0)]                       # [Bc,d]
    return logits, caches._replace(lens=new_lens), tuple(tails), hidden_last


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
        lg, caches, _, _ = ess_prefill_chunk(
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
    fetch = side_stream(dev)
    for _ in range(max_new_tokens - 1):
        t0 = time.perf_counter()
        o = ess_decode(params, cfg, tok[:, None], caches.lens[:, None], caches,
                       fetch_stream=fetch)
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


# ---------------------------------------------------------------------------
# Continuous-batching serve session
# ---------------------------------------------------------------------------

def device_get(parts: list, pinned: Optional[torch.Tensor] = None
               ) -> np.ndarray:
    """The serve round's one host fetch: the int64 device tensors
    ``parts`` packed on the device, one non-blocking copy into the
    ``pinned`` host buffer, one event wait.  On the CPU, a copy."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    if flat.device.type != "cuda":
        return flat.numpy().copy()
    dst = pinned[:flat.numel()]
    dst.copy_(flat, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return dst.numpy().copy()


# decode rounds before a freshly promoted slot's working set is warm and,
# pipelined, its slab filled (round N computes on rows staged in round
# N-1, planned from round N-2's scores); excluded from the decode cadence
# (ServeReport.rounds_per_s) in both modes, as in the reference
PIPELINE_FILL_ROUNDS = 2


@dataclasses.dataclass
class ServeReport:
    rounds: int = 0                     # decode rounds stepped
    decode_tokens: int = 0              # tokens emitted by decode rounds
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    wall_s: float = 0.0
    # wall time inside decode rounds (plan -> commit) outside each slot's
    # first PIPELINE_FILL_ROUNDS rounds (those count in fill_rounds)
    decode_wall_s: float = 0.0
    fill_rounds: int = 0
    h2d_rows: int = 0                   # miss rows read from the host tier
    hit_rows: int = 0                   # pool hits (port-only counter)
    d2h_rows: int = 0                   # latent rows written (all layers)
    host_bytes_per_row: int = 0         # payload + scale bytes of a row
    finished_rids: list = dataclasses.field(default_factory=list)
    admissions_blocked: int = 0
    peak_pages_in_use: int = 0
    num_pages: int = 0
    ttft_rounds: dict = dataclasses.field(default_factory=dict)
    ttft_s: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    rejected: int = 0
    aborted: int = 0
    finish_reasons: dict = dataclasses.field(default_factory=dict)
    # MTP speculative accounting: with mtp_depth > 0 a round emits 1 to
    # depth + 1 tokens per live slot, so decode_tokens counts accepted
    # tokens and tokens_per_s is accepted tokens per second
    spec_rounds: int = 0                # rounds run as draft + verify
    drafted_tokens: int = 0             # greedy slots' drafts scored
    accepted_tokens: int = 0            # drafts accepted (bonus excluded)
    # the pipelined round's prefetch accounting, summed over layers and
    # slots: staged rows that served misses, misses the fallback gathered,
    # staged rows nobody requested
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_wasted_rows: int = 0

    @property
    def prefetch_hit_rate(self) -> float:
        """Slab hits over the misses that needed tier rows."""
        tot = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / tot if tot else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def rounds_per_s(self) -> float:
        denom = self.decode_wall_s if self.decode_wall_s > 0 else self.wall_s
        return (self.rounds - self.fill_rounds) / denom if denom > 0 else 0.0

    @property
    def pool_hit_rate(self) -> float:
        tot = self.hit_rows + self.h2d_rows
        return self.hit_rows / tot if tot else 0.0

    @property
    def h2d_bytes(self) -> int:
        return self.h2d_rows * self.host_bytes_per_row

    @property
    def accept_rate(self) -> float:
        """Accepted drafts / drafted tokens (greedy speculative slots)."""
        return self.accepted_tokens / self.drafted_tokens \
            if self.drafted_tokens else 0.0


class _RoundPlan(NamedTuple):
    active: list            # slots stepping this round
    pending: list           # (slot, req, t0 device tensor) first tokens
    spec: bool              # an MTP draft + verify round
    sampled: bool           # some active slot samples: the sampling variant
    t0: float               # plan-stage entry time


@dataclasses.dataclass
class _PrefillTask:
    req: Request
    tokens: torch.Tensor     # [1, prompt_len] on the session's device
    cursor: int = 0
    # per-layer post-ln1 tails of the last warmup_windows prompt positions
    # (do_warmup sessions), accumulated across chunks
    tails: Optional[list] = None


class ServeSession:
    """One long-lived ESS decode batch driven by the continuous-batching
    scheduler (counterpart of ``repro.serving.engine.ServeSession``).

    * ``num_slots`` decode slots share one batch; more requests than slots
      stream through as slots free up.
    * Prefill is chunked and interleaved: each round runs one
      ``prefill_chunk``-token chunk for at most one admitting slot, then
      one decode step for all running slots.  Chunk latents go straight
      into the slot's mapped host pages.
    * Admission is gated in host **bytes** (``host_byte_budget``, floored
      to whole pages of the tier's storage dtype) or pages
      (``num_host_pages``), and in pool entries.  A finished, preempted or
      aborted slot returns its pages and gets a full reset (``lens`` and
      pool maps) in place; decode masks frozen slots inside the step.
    * ``mtp_depth > 0`` runs every decode round as an **MTP speculative
      round**: draft ``mtp_depth`` tokens per slot from the carried hidden
      (``mtp_draft``), verify them in one Q = depth + 1 ``ess_decode``,
      emit the accepted prefix and the bonus token, and roll ``lens`` and
      the pools back for the rejected drafts.  Sampling requests emit one
      token per round, drawn from the verify step's first position.  The
      streams equal the Q = 1 session's where the verify step's first
      position gives the Q = 1 step's logits (a MoE whose capacity binds
      lets the drafts take experts from the real tokens, as in the
      reference).
    * ``tbo=True`` (with two slots or more) composes Two-Batch Overlap:
      every decode and verify step splits the slots into two halves that
      step on two streams (:mod:`repro_torch.serving.tbo`).  The layers'
      overlap modes are ``cfg.ess.overlap``'s (``layerwise`` without a
      policy is DA, as in the reference's sessions).
    * Sampled requests (``temperature > 0``, with ``top_k`` / ``top_p``)
      draw with the reference's per-request keys, ``fold_in(key(seed),
      emission index)`` over JAX's threefry
      (:mod:`repro_torch.serving.sampling`), so their streams equal the
      reference's.
    * ``compiled=True`` replays each round kind as a CUDA graph over the
      persistent :class:`~repro_torch.serving.state.EngineState`
      (:mod:`repro_torch.serving.step`), a greedy and a sampling variant
      picked on the host; ``compiled=False`` runs the same round
      functions eagerly, and emits the same streams.  The CPU has only
      the eager form.
    * Exactly one host fetch per decode round, in :meth:`_commit_round`:
      the packed round result and the just-promoted slots' first tokens,
      one non-blocking copy into a pinned buffer and one event wait
      (:func:`device_get`).  Prefill chunks and decode rounds are
      otherwise free of host syncs.
    * ``do_warmup=True`` runs the LRU-warmup replay after a slot's last
      chunk (ragged chunks, the first token resolved on the host, as the
      reference's legacy path does).
    * ``overlap=True`` runs every round **pipelined** (plan -> compute ->
      commit): each layer's misses come from the round's own rows, a
      staging slab of ``prefetch_rows`` rows per layer and slot filled
      during the previous round, and a fallback gather; the appended rows
      reach the tier in one stacked write at the end, and the slab for the
      next round is planned from this round's indexer scores and gathered
      on the fetch stream (:mod:`repro_torch.core.transfer`).  The streams
      equal the synchronous session's; ``report`` counts prefetch hits,
      misses and wasted rows.  The slab's default size is the miss
      envelope, ``max_miss_ratio * min(index_topk, max_seq)`` rows.
    """

    def __init__(self, params: dict, cfg: ArchConfig, *, num_slots: int,
                 max_seq: int, num_host_pages: Optional[int] = None,
                 host_byte_budget: Optional[int] = None,
                 prompt_fn: Optional[Callable[[Request], Any]] = None,
                 do_warmup: bool = False, prefill_chunk: int = 64,
                 mtp_depth: int = 0, tbo: bool = False,
                 compiled: bool = True, overlap: bool = False,
                 prefetch_rows: Optional[int] = None, device=None):
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.do_warmup = do_warmup
        self.compiled = compiled
        self.prefill_chunk = max(1, prefill_chunk)
        if mtp_depth > cfg.mtp_depth:
            raise ValueError(f"mtp_depth {mtp_depth} > cfg.mtp_depth "
                             f"{cfg.mtp_depth} stacked draft modules")
        self.mtp_depth = max(0, mtp_depth)
        self.tbo = tbo and num_slots >= 2
        self.overlap = overlap
        self.prefetch_rows = 0
        if overlap:
            self.prefetch_rows = prefetch_rows if prefetch_rows is not None \
                else max(1, int(cfg.ess.max_miss_ratio
                                * min(cfg.dsa.index_topk, max_seq)))
        self.paged = LC.uses_paged_host(cfg)
        blocks_per_slot = LC.num_blocks(cfg, max_seq)
        self.num_pages = 0
        self.allocator: Optional[LC.HostPageAllocator] = None
        self.host_row_bytes = LC.host_row_bytes(cfg, cfg.param_dtype)
        self.host_page_bytes = LC.host_page_bytes(cfg, cfg.param_dtype)
        if self.paged:
            if host_byte_budget is not None:
                by_bytes = host_byte_budget // max(1, self.host_page_bytes)
                self.num_pages = by_bytes if num_host_pages is None \
                    else min(by_bytes, num_host_pages)
            else:
                self.num_pages = (num_host_pages
                                  if num_host_pages is not None
                                  else num_slots * blocks_per_slot)
            self.allocator = LC.HostPageAllocator(self.num_pages)
        caches = LC.init_ess_caches(
            cfg, num_slots, max_seq, cfg.param_dtype, device=self.device,
            num_pages=self.num_pages if self.paged else None,
            map_slots=not self.paged)
        self.state = ES.init_engine_state(cfg, caches, num_slots,
                                          prefetch_rows=self.prefetch_rows)
        # the slab's lifecycle edges and the prefetch accounting; None
        # when synchronous
        self.transfer: Optional[TR.TransferEngine] = None
        if self.prefetch_rows > 0:
            hs = caches.host_scales
            self.transfer = TR.TransferEngine(
                cfg.num_layers, num_slots, self.prefetch_rows,
                caches.host_latent.shape[-1], caches.host_latent.dtype,
                scale_dtype=None if hs is None else hs.dtype)
        self._out = ES.init_round_out(num_slots, self.mtp_depth + 1,
                                      self.device,
                                      prefetch=self.transfer is not None)
        # the fetch's host side: the round result plus a first token per
        # slot at most
        self._pinned = None
        if self.device.type == "cuda":
            self._pinned = torch.empty(
                (self._out.packed.numel() + num_slots,),
                dtype=torch.int64).pin_memory()
        self._programs = SP.StepPrograms(cfg, self.mtp_depth, tbo=self.tbo,
                                         device=self.device)
        self.pool_entries_per_slot = LC.pool_entries(cfg, max_seq)
        self.free_pool_entries = num_slots * self.pool_entries_per_slot
        self.sched = Scheduler(num_slots, max_seq,
                               admission_gate=self._admission_gate,
                               release_hook=self._release_slot,
                               reject_hook=self._reject)
        self.outputs: dict[int, list[int]] = {}
        self.report = ServeReport(num_pages=self.num_pages,
                                  host_bytes_per_row=self.host_row_bytes)
        self.token_events: list[TokenEvent] = []
        self._pending_events: list[TokenEvent] = []
        self._terminal: dict[int, str] = {}
        self._last_done: list[Request] = []
        self._prompt_fn = prompt_fn or self._default_prompt
        self._promised_pages = 0
        self._promised_slots = 0
        self._prefill: dict[int, _PrefillTask] = {}
        self._pending_first: list[tuple] = []
        self._rounds_since_promote: dict[int, int] = {}
        self._round = 0
        self._submit_round: dict[int, int] = {}
        self._submit_time: dict[int, float] = {}

    @property
    def caches(self) -> LC.ESSCaches:
        return self.state.caches

    @property
    def programs(self) -> SP.StepPrograms:
        return self._programs

    # -- resource accounting -------------------------------------------------

    def _default_prompt(self, req: Request) -> torch.Tensor:
        """Random prompt tokens from a CPU ``torch.Generator`` seeded with
        ``1000 + rid``.  This differs from the reference's default prompt,
        which draws with ``jax.random``: a comparison of the two packages
        passes the same ``prompt_fn`` to both."""
        g = torch.Generator().manual_seed(1000 + req.rid)
        return torch.randint(0, self.cfg.vocab_size, (1, req.prompt_len),
                             generator=g)

    def _prompt_tokens(self, req: Request) -> torch.Tensor:
        p = self._prompt_fn(req)
        if isinstance(p, torch.Tensor) and p.device == self.device:
            return p.reshape(1, -1).long()      # already on the device
        t = torch.as_tensor(np.asarray(p)).long()
        return upload(t.reshape(1, -1), self.device)

    def pages_needed(self, req: Request) -> int:
        return LC.pages_for_len(self.cfg, req.prompt_len + req.max_new_tokens)

    def _admission_gate(self, req: Request) -> bool:
        need_entries = self.pool_entries_per_slot * (self._promised_slots + 1)
        if self.free_pool_entries < need_entries:
            return False
        need = self.pages_needed(req)
        if self.allocator is not None:
            # pages are the allocation unit; host bytes are the budget
            need_bytes = need * self.host_page_bytes
            free_bytes = (self.allocator.free_pages
                          - self._promised_pages) * self.host_page_bytes
            if need_bytes > free_bytes:
                ev = (f"blocked rid={req.rid}: needs {need_bytes} host "
                      f"bytes ({need} pages), {free_bytes} free")
                if not self.report.events or self.report.events[-1] != ev:
                    self.report.events.append(ev)
                return False
        self._promised_pages += need
        self._promised_slots += 1
        return True

    def _release_slot(self, slot: int) -> None:
        # a mid-prefill preemption drops the chunk cursor
        self._prefill.pop(slot, None)
        if self.allocator is not None:
            self.allocator.release(slot)
            LC.unmap_slot(self.caches, slot)
        LC.reset_slot(self.caches, slot)
        ES.release_slot(self.state, slot)
        self._rounds_since_promote.pop(slot, None)
        self.free_pool_entries += self.pool_entries_per_slot

    def _sample_pages(self) -> None:
        if self.allocator is not None:
            used = self.num_pages - self.allocator.free_pages
            self.report.peak_pages_in_use = max(
                self.report.peak_pages_in_use, used)

    # -- event stream --------------------------------------------------------

    def _event(self, ev: TokenEvent) -> None:
        self._pending_events.append(ev)
        self.token_events.append(ev)

    def drain_events(self) -> list[TokenEvent]:
        evs, self._pending_events = self._pending_events, []
        return evs

    def _finalize(self, req: Request) -> None:
        """The request's single terminal event."""
        reason = req.finish_reason or "length"
        if req.rid in self._terminal:
            raise RuntimeError(f"rid={req.rid} already terminal "
                               f"({self._terminal[req.rid]})")
        self._terminal[req.rid] = reason
        self.report.finish_reasons[req.rid] = reason
        self._event(TokenEvent(rid=req.rid, token=None,
                               index=len(self.outputs.get(req.rid, [])),
                               finish_reason=reason,
                               t=time.perf_counter()))

    def _reject(self, req: Request) -> None:
        self.report.rejected += 1
        self.report.events.append(
            f"rejected rid={req.rid}: prompt {req.prompt_len} + max_new "
            f"{req.max_new_tokens} > max_seq {self.sched.max_seq}")
        self._finalize(req)

    # -- request flow --------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._submit_round[req.rid] = self._round
        self._submit_time[req.rid] = time.perf_counter()
        if self.allocator is not None \
                and self.pages_needed(req) > self.num_pages:
            req.finished = True
            req.finish_reason = "rejected"
            self.sched.finished.append(req)
            self.report.rejected += 1
            self.report.events.append(
                f"rejected rid={req.rid}: needs {self.pages_needed(req)} "
                f"pages, pool has {self.num_pages}")
            self._finalize(req)
            return
        self.sched.submit(req)

    def abort(self, rid: int, *, reason: str = "abort") -> bool:
        """Abort a queued or running request between rounds; a running
        slot returns its pages and is reset at once."""
        req = self.sched.running.get(rid)
        if req is None:
            req = next((r for r in self.sched.queue if r.rid == rid), None)
        if req is None or req.finished:
            return False
        req.finish_reason = reason
        if not self.sched.abort(rid):
            raise RuntimeError(f"rid={rid}: the scheduler lost it")
        self.report.aborted += 1
        self.report.events.append(
            f"round {self._round}: rid={rid} aborted ({reason})")
        self._finalize(req)
        return True

    def preempt(self, slot: int) -> None:
        """Evict a running slot; it requeues, and its pages return and its
        caches reset through the scheduler's release hook."""
        self.sched.preempt(slot)

    def admit(self) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots: allocate and map host
        pages and queue the slot's prompt for chunked prefill."""
        self._promised_pages = 0
        self._promised_slots = 0
        admitted = self.sched.admit()
        for slot, req in admitted:
            if self.allocator is not None:
                pages = self.allocator.alloc(slot, self.pages_needed(req))
                LC.map_slot(self.caches, slot, pages)
            self._sample_pages()
            self.free_pool_entries -= self.pool_entries_per_slot
            self._prefill[slot] = _PrefillTask(req, self._prompt_tokens(req))
            ES.admit_slot(self.state, slot, req)
            self.outputs[req.rid] = []
            self.report.events.append(
                f"round {self._round}: rid={req.rid} -> slot {slot} "
                f"(prefill {req.prompt_len} toks, "
                f"preempted {req.preempted_count}x)")
        return admitted

    def prefill_round(self) -> bool:
        """One prefill chunk for the oldest admitting slot (if any).

        Without warmup the chunk is bucketed to a power of two (a ragged
        last chunk zero-padded and masked by ``n_valid``); the last chunk
        selects the first token on the device and promotes the slot, and
        the token rides this round's one fetch in :meth:`decode_round`.
        With ``do_warmup`` the chunk is ragged, collects the warmup tails,
        and the last one runs the LRU-warmup replay and resolves the first
        token on the host."""
        if not self._prefill:
            return False
        slot = next(iter(self._prefill))         # FIFO by insertion order
        task = self._prefill[slot]
        n = task.req.prompt_len
        c0 = task.cursor
        ck = min(self.prefill_chunk, n - c0)
        last = c0 + ck >= n
        if self.do_warmup:
            t0 = self._prefill_chunk_warmup(slot, task, c0, ck, n, last)
        else:
            C = SP.chunk_bucket(ck, self.prefill_chunk)
            toks = task.tokens[:, c0:c0 + ck]
            if C > ck:
                toks = torch.nn.functional.pad(toks, (0, C - ck))
            t0_dev = self._programs.prefill(C, last, task.req.sampling)(
                self.params, self.state, toks, slot, ck)
        task.cursor += ck
        self.report.prefill_chunks += 1
        self.report.prefill_tokens += ck
        self.report.events.append(
            f"round {self._round}: rid={task.req.rid} prefill chunk "
            f"[{c0}:{c0 + ck})/{n} (slot {slot})")
        if last:
            if self.do_warmup:
                self._finish_prefill(slot, task, t0)
            else:
                self.sched.promote(slot)
                self._rounds_since_promote[slot] = 0
                del self._prefill[slot]
                self._pending_first.append((slot, task.req, t0_dev))
        return True

    def _prefill_chunk_warmup(self, slot: int, task: _PrefillTask, c0: int,
                              ck: int, n: int, last: bool) -> Optional[int]:
        W = max(0, min(self.cfg.ess.warmup_windows, n - 1))
        toks = task.tokens[:, c0:c0 + ck]
        pos = torch.arange(c0, c0 + ck, device=self.device)[None]
        lg, new, tails, hid_last = ess_prefill_chunk(
            self.params, self.cfg, toks, pos, self.caches, slot=slot,
            want_logits=last, collect_tail=min(W, ck))
        self.caches.lens.copy_(new.lens)
        if W > 0:
            if task.tails is None:
                task.tails = list(tails)
            else:
                task.tails = [torch.cat([a, b], dim=1)[:, -W:]
                              for a, b in zip(task.tails, tails)]
        if not last:
            return None
        if W > 0:
            self._warmup_slot(slot, tuple(task.tails), n)
        req = task.req
        t0 = self._draw(req, lg[0, -1], 0) if req.sampling \
            else greedy(lg[0, -1])
        ES.promote_slot(self.state, slot, t0, hid_last[0])
        # the legacy path resolves the first token here, on the host
        return int(t0)

    def _deliver_first_token(self, slot: int, req: Request, t0: int,
                             now: Optional[float] = None) -> Optional[str]:
        """Deliver a freshly promoted slot's first token; returns
        ``"stop"`` / ``"length"`` when the request ends there."""
        if now is None:
            now = time.perf_counter()
        self.outputs[req.rid] = [t0]
        self._event(TokenEvent(rid=req.rid, token=t0, index=0, t=now))
        rid = req.rid
        ttft = self._round - self._submit_round[rid]
        self.report.ttft_rounds.setdefault(rid, ttft)
        self.report.ttft_s.setdefault(rid, now - self._submit_time[rid])
        self.report.events.append(
            f"round {self._round}: rid={rid} first token ready "
            f"(ttft {ttft} rounds)")
        if t0 in req.stop_set:
            req.finish_reason = "stop"
            return "stop"
        if self.sched.budget_left(slot) == 0:
            return "length"
        return None

    def _finish_prefill(self, slot: int, task: _PrefillTask,
                        t0: int) -> None:
        req = task.req
        self.sched.promote(slot)
        self._rounds_since_promote[slot] = 0
        del self._prefill[slot]
        done = self._deliver_first_token(slot, req, t0)
        if done == "stop":
            self._handle_done([self.sched.finish(slot)])
        elif done == "length":
            self._handle_done(self.sched.record_tokens({slot: 0}))

    def _warmup_slot(self, slot: int, tails: tuple, prompt_len: int) -> None:
        """LRU-warmup replay for one freshly prefilled slot: the top-K sets
        of the last W prefill windows go into a fresh batch-1 pool, read
        from the slot's mapped pages, which is then grafted into the
        shared pool with clock-clamped stamps."""
        caches = self.caches
        lens1 = torch.full((1,), prompt_len, dtype=torch.int64,
                           device=self.device)
        for layer, x_tail in enumerate(tails):
            lp, _ = _layer_params(self.params, self.cfg, layer)
            full = caches.pools[layer]
            one = LP.init_pool(1, full.data.shape[1],
                               caches.ikeys[layer].shape[1],
                               full.data.shape[2], full.data.dtype,
                               self.device)
            one = WU.lru_warmup(
                one, caches.host_latent, x_tail, lp["indexer"],
                caches.ikeys[layer][slot:slot + 1], lens1, self.cfg,
                slot_mask=None, layer=layer, batch_offset=slot,
                block_table=caches.block_tables,
                host_scales=caches.host_scales)
            LC.graft_pool_into(full, one, slot)

    # -- decode stepping -----------------------------------------------------

    def _slot_req(self, slot: int) -> Request:
        return self.sched.running[self.sched.slots[slot].rid]

    def _draw(self, req: Request, logits: torch.Tensor,
              index: int) -> torch.Tensor:
        """One token of a sampling request from ``logits [V]`` with Python
        knobs.  ``index`` is the chain position (0 = the prefill's first
        token): the one place the key is derived, so sampled streams are
        the same at Q = 1 and in speculative rounds."""
        return sample(request_key(req.sample_seed, index, logits.device),
                      logits, req.temperature, req.top_k, req.top_p)

    def _emit(self, slot: int, req: Request, tokens: list[int],
              now: Optional[float] = None) -> tuple[int, bool]:
        """Deliver one slot's tokens of the round; returns
        ``(budget charge, stop-token hit)``.  The charge equals the
        delivery: both are clamped by the same headroom."""
        out = self.outputs.setdefault(req.rid, [])
        delivered = tokens[:max(0, self.sched.remaining(slot))]
        stopped = False
        for j, t in enumerate(delivered):
            if t in req.stop_set:
                delivered = delivered[:j + 1]
                stopped = True
                break
        if now is None:
            now = time.perf_counter()
        for t in delivered:
            self._event(TokenEvent(rid=req.rid, token=t, index=len(out),
                                   t=now))
            out.append(t)
        if stopped:
            req.finish_reason = "stop"
        return len(delivered), stopped

    def _truncate_slot_tail(self, slot: int, n_drop: int) -> None:
        """Roll back the last ``n_drop`` appended positions of one slot (a
        stop token inside a speculative round), in place and outside the
        round's graph: ``lens`` shrinks and every pool drops its entries
        beyond, the MTP rejection's rollback, so the slot matches a run
        that never drafted past the stop.  (Indexer keys and host rows
        beyond ``lens`` are dead and reset with the slot.)"""
        if n_drop <= 0:
            return
        lens = self.caches.lens
        lens[slot].sub_(n_drop)                 # a Python int: no host copy
        for p in self.caches.pools:
            LP.invalidate_beyond(p, lens)
        if self.transfer is not None:
            # staged ids beyond the cut: their rows are about to be
            # written again (the new length stays on the device)
            self.transfer.truncate_slot(self.state, slot, lens[slot])

    def _plan_round(self) -> Optional[_RoundPlan]:
        """Plan stage: sample page pressure, collect the just-promoted
        slots' first tokens, pick the active slots (None: nothing to
        step).  No device work."""
        self._sample_pages()
        pending, self._pending_first = self._pending_first, []
        # drop entries of slots preempted or aborted before their fetch
        pending = [(s, r, t) for s, r, t in pending
                   if self.sched.slots[s].active
                   and self.sched.slots[s].rid == r.rid]
        active = self.sched.active_slots()
        if not active:
            if pending:
                raise RuntimeError("a promoted slot must be active")
            return None
        # the sampler runs only when a live slot samples (the reference's
        # device-side cond, decided here from the scheduler's requests)
        sampled = any(self._slot_req(i).sampling for i in active)
        return _RoundPlan(active=active, pending=pending,
                          spec=self.mtp_depth > 0, sampled=sampled,
                          t0=time.perf_counter())

    def _compute_round(self, plan: _RoundPlan) -> ES.RoundOut:
        """Compute stage: the round of the plan's kind and variant (a graph
        replay, or eager) over the persistent state; nothing here waits
        for the card."""
        progs = self._programs
        fn = progs.spec if plan.spec else progs.decode
        fn(self.compiled, plan.sampled)(self.params, self.state, self._out)
        return self._out

    def _commit_round(self, plan: _RoundPlan,
                      out: ES.RoundOut) -> list[Request]:
        """Commit stage: the round's single fetch (the packed result and
        the pending first tokens), then scheduler bookkeeping and the
        stream, stamped with the delivery instant."""
        active, pending, spec = plan.active, plan.pending, plan.spec
        host = device_get([out.packed] + [t for _, _, t in pending],
                          self._pinned)
        t_deliver = time.perf_counter()
        B, n = self.num_slots, out.packed.numel()
        nq = B * out.tokens.shape[1]
        toks = host[:nq].reshape(B, -1)
        n_emit = host[nq:nq + B]
        self.report.h2d_rows += int(host[nq + B])
        self.report.hit_rows += int(host[nq + B + 1])
        if self.transfer is not None:
            pf = host[nq + B + 2:n].reshape(3, B).sum(1)
            self.transfer.commit(self.report, *pf)
        t0s = host[n:]
        # every live slot appends Q latent rows per layer
        q_round = self.mtp_depth + 1 if spec else 1
        self.report.d2h_rows += len(active) * q_round * self.cfg.num_layers
        slot_tokens = {}
        stop_slots = []
        first_done = {}
        for (s0, r0, _), t0 in zip(pending, t0s):
            fd = self._deliver_first_token(s0, r0, int(t0), now=t_deliver)
            if fd is not None:
                first_done[s0] = fd
        for i in active:
            req = self._slot_req(i)
            if i in first_done:
                # ended at its first token; the slot's decode step is
                # discarded when it releases (full reset)
                slot_tokens[i] = 0
                if first_done[i] == "stop":
                    stop_slots.append(i)
                continue
            k = int(n_emit[i])
            charged, stopped = self._emit(i, req,
                                          [int(t) for t in toks[i, :k]],
                                          now=t_deliver)
            slot_tokens[i] = charged
            if stopped:
                # a verify round may have appended past the stop: drop the
                # over-accepted suffix from the slot's lens and pools
                self._truncate_slot_tail(i, k - charged)
                stop_slots.append(i)
            if spec and not req.sampling:
                self.report.drafted_tokens += self.mtp_depth
                self.report.accepted_tokens += k - 1
        done = self.sched.record_tokens(slot_tokens)
        for i in stop_slots:
            if self.sched.slots[i].active:
                done.append(self.sched.finish(i))
        fill = any(self._rounds_since_promote.get(i, PIPELINE_FILL_ROUNDS)
                   < PIPELINE_FILL_ROUNDS for i in active)
        for i in active:
            if self._rounds_since_promote.get(i, 99) < PIPELINE_FILL_ROUNDS:
                self._rounds_since_promote[i] += 1
        self.report.rounds += 1
        if spec:
            self.report.spec_rounds += 1
        self.report.decode_tokens += sum(slot_tokens.values())
        if fill:
            self.report.fill_rounds += 1
        else:
            self.report.decode_wall_s += time.perf_counter() - plan.t0
        return done

    def decode_round(self) -> list[Request]:
        """One decode round over the running slots (plan -> compute ->
        commit); returns the requests it finished."""
        plan = self._plan_round()
        if plan is None:
            return []
        out = self._compute_round(plan)
        return self._commit_round(plan, out)

    def _handle_done(self, done: list[Request]) -> None:
        for req in done:
            out = self.outputs.get(req.rid, [])
            if len(out) != req.generated + 1:
                raise RuntimeError(f"rid={req.rid}: delivered {len(out)} != "
                                   f"generated {req.generated} + 1")
            self._finalize(req)
            self.report.events.append(
                f"round {self._round}: rid={req.rid} finished "
                f"({len(out)} tokens, {req.finish_reason})")

    def step_round(self) -> list[TokenEvent]:
        """One serve round — admissions, one prefill chunk for at most one
        admitting slot, one decode step for all running slots; returns the
        round's TokenEvents."""
        t0 = time.perf_counter()
        self.admit()
        self.prefill_round()
        done = self.decode_round()
        self._handle_done(done)
        self._round += 1
        self._last_done = done
        self.report.wall_s += time.perf_counter() - t0
        return self.drain_events()

    def step(self) -> list[Request]:
        """:meth:`step_round` returning the round's finished requests
        (events stay buffered)."""
        evs = self.step_round()
        self._pending_events = evs + self._pending_events
        return self._last_done

    def _terminate_remaining(self, reason: str) -> None:
        for rid in [r.rid for r in self.sched.queue] + \
                list(self.sched.running):
            self.abort(rid, reason=reason)

    def run(self, requests=None, *, max_rounds: int = 200,
            on_round: Optional[Callable[["ServeSession", int], None]] = None
            ) -> ServeReport:
        """Drive :meth:`step_round` until every submitted request has its
        terminal event; requests still unfinished after ``max_rounds``
        rounds end with ``finish_reason="budget"``."""
        for req in (requests or []):
            self.submit(req)
        budget = max_rounds
        while self.sched.running or self.sched.queue:
            self.step_round()
            if on_round is not None:
                on_round(self, self._round - 1)
            budget -= 1
            if budget <= 0:
                self.report.events.append("max_rounds reached")
                self._terminate_remaining("budget")
                break
        self.report.finished_rids = [r.rid for r in self.sched.finished]
        self.report.admissions_blocked = self.sched.blocked_admissions
        missing = [rid for rid in self._submit_round
                   if rid not in self._terminal]
        if missing:
            raise RuntimeError(f"no terminal event for rids {missing}")
        return self.report
