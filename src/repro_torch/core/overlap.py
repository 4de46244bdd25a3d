"""ESS decode attention with the DA / DBA overlap strategies (paper
section 3.3; counterpart of ``repro.core.overlap``).

* ``none``: one attention over the union of pool hits and fetched misses;
  everything waits for the fetch, on one stream.
* ``da`` (Dual-Attention): the miss fetch is forked onto a side stream;
  **Attn0** runs over pool-resident rows on the current stream meanwhile,
  and **Attn1** over the fetched rows after the join; the two unnormalized
  partials merge exactly.
* ``dba`` (DualBatch-Attention): the batch splits in two; half-1's fetch
  runs on the side stream while half-2's indexer, top-k and pool lookup
  run on the current stream, then half-2's fetch, then both halves finish
  as DA does.  ``B // 2 == 0`` is DA.

The reference states these as program structures whose independence lets
XLA's latency-hiding scheduler hide the host-to-device fetch.  On the card
the counterpart is a second CUDA stream with a fork and a join
(:class:`Fork`); a fork and a join recorded inside a graph capture become
parallel branches of the CUDA graph, so the overlap survives replay.  The
fetch stream is the caller's (``fetch_stream``; the serve round's
``StepPrograms`` makes it once, at high priority, so that the gather's
CTAs get SMs beside Attn0's); without one, or on CPU tensors, everything
runs on the current stream in the same order and computes the same
numbers.

Both attends run the sparse-MLA partial kernel, the fetch runs the UVA
row-gather kernel (its fused dequant variant for a quantized tier, which
returns bf16 rows as the reference's does), and the indexer scores run
the indexer kernel.  The pool is updated in place; admission casts the
fetched rows to the pool's dtype.  Q>1 (draft verification) flattens the
per-query top-k into one pool lookup and keeps each query causal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.core import transfer as TR
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.sparse_mla import ops as sk
from repro_torch.models import mla as M


def side_stream(device) -> torch.cuda.Stream | None:
    """A new high-priority CUDA stream on ``device`` for forked work (the
    miss fetch, a TBO half); None on the CPU.  Make it outside any graph
    capture."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.Stream(device, priority=-1)


class Fork:
    """Work forked onto ``stream`` and joined back later.

    ``with Fork(stream, *crossing) as f:`` enqueues the block on
    ``stream`` after everything the current (home) stream has enqueued so
    far; ``f.join()`` makes the home stream wait for the block's work,
    and nothing later on ``stream``.  ``crossing`` are the tensors made on
    the home stream that the block reads or writes (its output included,
    allocated on the home stream before the fork): they are kept alive
    until the join, so the caching allocator cannot hand their memory to
    the home stream while the side stream still uses it.  With ``stream``
    None or CPU tensors the block runs on the home stream and ``join`` does
    nothing.  Every fork must be joined before a graph capture ends."""

    def __init__(self, stream: torch.cuda.Stream | None,
                 *crossing: torch.Tensor):
        self.active = stream is not None and crossing[0].is_cuda
        self._stream = stream
        self._keep = crossing
        self._done = None

    def __enter__(self) -> "Fork":
        if self.active:
            self._home = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(self._home)
            self._ctx = torch.cuda.stream(self._stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.active:
            self._done = self._stream.record_event()
            self._ctx.__exit__(*exc)

    def join(self) -> None:
        if self._done is not None:
            self._home.wait_event(self._done)
            self._done = None
        self._keep = ()


class ESSLayerState(NamedTuple):
    pool: LP.PoolState            # device-resident sparse memory pool
    host_latent: torch.Tensor     # dense [L,B,S,D] / paged [L,NP,R,D]
    layer: int = 0                # layer index into a stacked tier
    batch_offset: int = 0         # row offset into the tier's batch
    block_table: torch.Tensor | None = None   # [B_total, NB] (paged)
    host_scales: torch.Tensor | None = None   # quantized tier: row scales


class ESSStats(NamedTuple):
    hits: torch.Tensor
    misses: torch.Tensor
    overflow: torch.Tensor


def _attend_rows(q_comb: torch.Tensor, rows: torch.Tensor,
                 valid: torch.Tensor, cfg: ArchConfig) -> M.Partial:
    """q [B,Q,H,D] vs per-query rows [B,Q,K,D] (or shared [B,K,D]); the
    sparse-MLA kernel (fp32 math, as the reference's ``use_kernel=True``):
    bf16 at MLA's widths takes the tensor-core route, fp32 the general one
    (``kernels/sparse_mla/ops.tc_route``).  Rows of another dtype (a
    quantized tier's bf16 misses under fp32 params) widen to the query's,
    as the reference's promotion does."""
    return shd.local_call(sk.partial_attend, q_comb, rows.to(q_comb.dtype),
                          valid, M.mla_scale(cfg), cfg.mla.kv_lora_rank)


def ess_sparse_attention(mla_p: dict, idx_p: dict, cfg: ArchConfig,
                         x_norm: torch.Tensor, positions: torch.Tensor,
                         state: ESSLayerState, idx_keys: torch.Tensor,
                         lens: torch.Tensor, *, overlap: str = "da",
                         slot_mask: torch.Tensor | None = None,
                         fetch_stream: torch.cuda.Stream | None = None
                         ) -> tuple[torch.Tensor, ESSLayerState, ESSStats]:
    """One layer of ESS decode attention.

    x_norm [B,Q,d], positions [B,Q], idx_keys [B,S,Di] already holding the
    new tokens' keys, lens [B] (or per-query [B,Q]) = cache length after
    the append; ``state.host_latent`` already holds the new latent rows
    (written on the current stream, so a fetch forked after it sees them).
    ``slot_mask`` [B] gates frozen rows' pool mutations.  ``fetch_stream``
    carries the miss fetch of ``da`` and ``dba`` (see the module
    docstring)."""
    if overlap == "dba":
        return _dba(mla_p, idx_p, cfg, x_norm, positions, state, idx_keys,
                    lens, slot_mask, fetch_stream)
    if overlap not in ("none", "da"):
        raise ValueError(f"overlap={overlap!r}: none | da | dba")
    return _da_or_none(mla_p, idx_p, cfg, x_norm, positions, state,
                       idx_keys, lens, overlap, slot_mask, fetch_stream)


def _fork_fetch(state: ESSLayerState, miss_ids: torch.Tensor,
                stream: torch.cuda.Stream | None, out_dtype=None
                ) -> tuple[torch.Tensor, Fork]:
    """Issue the miss fetch of ``miss_ids [B,M]`` on ``stream`` into rows
    allocated on the current stream (``out_dtype`` rows from a quantized
    tier; bf16 without one); returns ``(rows, fork)``: join the fork
    before reading the rows."""
    dt = offload.tier_rows_dtype(state.host_latent, state.host_scales) \
        if out_dtype is None else out_dtype
    rows = shd.empty_batch(miss_ids,
                           (*miss_ids.shape, state.host_latent.shape[-1]),
                           dt)
    with Fork(stream, miss_ids, rows) as fork:
        offload.gather_tier_rows(
            state.host_latent, state.host_scales, miss_ids,
            layer=state.layer, batch_offset=state.batch_offset,
            block_table=state.block_table, out=rows, out_dtype=out_dtype)
    return rows, fork


def _da_or_none(mla_p, idx_p, cfg, x_norm, positions, state, idx_keys, lens,
                overlap, slot_mask, fetch_stream):
    pool, lk, stats, ids, req_valid, K, M_env, _ = _topk_and_lookup(
        idx_p, cfg, x_norm, state, idx_keys, lens, slot_mask)
    # issue the fetch first; DA forks it (Attn0 does not depend on it),
    # the union attention of ``none`` waits for it
    fetched, fork = _fork_fetch(state, lk.miss_ids,
                                fetch_stream if overlap == "da" else None)
    out, pool = _finish_attention(mla_p, cfg, x_norm, positions, pool, lk,
                                  ids, req_valid, fetched, fork, K, M_env,
                                  overlap, slot_mask)
    pool = LP.tick(pool)
    return out, state._replace(pool=pool), ESSStats(*stats)


def _fetch_valid(lk: LP.Lookup, B: int, Q: int, K: int, M_env: int
                 ) -> torch.Tensor:
    """[B,Q,M_env] bool — which fetched rows each query requested."""
    qidx = (torch.arange(Q * K, device=lk.miss_rank.device) // K)
    qidx = qidx[None].expand(B, Q * K)
    scat = lk.miss_rank.clamp_max(M_env)              # non-miss rank is big
    out = torch.zeros((B, Q, M_env + 1), dtype=torch.bool,
                      device=lk.miss_rank.device)
    bi = torch.arange(B, device=out.device)[:, None].expand(B, Q * K)
    out.index_put_((bi, qidx, scat), out.new_ones(()))
    return out[:, :, :M_env]


def _topk_and_lookup(idx_p, cfg, x_norm, state, idx_keys, lens, slot_mask):
    B, Q, _ = x_norm.shape
    S = idx_keys.shape[1]
    K = min(cfg.dsa.index_topk, S)
    M_env = max(1, int(cfg.ess.max_miss_ratio * K)) * Q

    qlens = lens[:, None] if lens.dim() == 1 else lens          # [B,Q]
    valid_s = (torch.arange(S, device=lens.device)[None, None, :]
               < qlens[:, :, None]).expand(B, Q, S)
    iq = M.indexer_query(idx_p, x_norm)
    sc = M.indexer_scores(iq, idx_keys, valid_s)                 # [B,Q,S]
    ids = M.topk_ids(sc, K, valid_s)                             # [B,Q,K]
    req_valid = valid_s.gather(2, ids)
    pool, lk, stats = LP.lookup(state.pool, ids.reshape(B, Q * K),
                                req_valid.reshape(B, Q * K), M_env,
                                slot_mask=slot_mask, dedup=Q > 1)
    return pool, lk, stats, ids, req_valid, K, M_env, sc


def _finish_attention(mla_p, cfg, x_norm, positions, pool, lk, ids,
                      req_valid, fetched, fork, K, M_env, overlap, slot_mask,
                      resolve=None):
    """Attn0 on pool-resident rows, Attn1 on ``fetched``, exact merge (or
    one union attention for ``none``); then LRU admission.  ``fork`` is
    the fetch's: joined before anything reads ``fetched`` (Attn1, the
    merge, the admission that writes the rows into the pool), and then
    ``resolve(fetched)``, if given, makes the miss rows from it (the staged
    round's sources).  Returns ``(out, pool)``; the caller ticks the
    clock."""
    B, Q, _ = x_norm.shape
    q_comb = M.absorbed_query(mla_p, cfg, x_norm, positions)     # [B,Q,H,D]
    D = fetched.shape[-1]

    def joined():
        fork.join()
        return fetched if resolve is None else resolve(fetched)
    if overlap == "none":
        fetched = joined()
        rows_hit, _ = LP.gather_resident(pool, lk.slot, lk.hit)
        fr = fetched.gather(1, lk.miss_rank.clamp(0, M_env - 1)[..., None]
                            .expand(B, Q * K, D))
        fr = torch.where((lk.miss_rank < M_env)[..., None], fr,
                         torch.zeros_like(fr))
        rows = torch.where(lk.hit[..., None], rows_hit, fr)
        valid = (lk.hit | (lk.miss_rank < M_env)) & \
            (ids.reshape(B, Q * K) >= 0)
        part = _attend_rows(q_comb, rows.view(B, Q, K, D),
                            valid.view(B, Q, K), cfg)
    else:
        rows0, _ = LP.gather_resident(pool, lk.slot, lk.hit)
        p0 = _attend_rows(q_comb, rows0.view(B, Q, K, D),
                          lk.hit.view(B, Q, K) & req_valid, cfg)
        mvalid = lk.miss_ids >= 0
        fvalid = _fetch_valid(lk, B, Q, K, M_env) & mvalid[:, None] \
            if Q > 1 else mvalid[:, None]
        fetched = joined()
        p1 = _attend_rows(q_comb, fetched[:, None].expand(B, Q, -1, D)
                          if Q > 1 else fetched[:, None], fvalid, cfg)
        part = M.merge_partials(p0, p1)

    out_lat = M.finalize_partial(part, x_norm.dtype)
    out = M.output_proj(mla_p, cfg, out_lat)
    pool = LP.admit(pool, lk.miss_ids, fetched, slot_mask=slot_mask)
    return out, pool


def _dba(mla_p, idx_p, cfg, x_norm, positions, state, idx_keys, lens,
         slot_mask, fetch_stream):
    """DualBatch-Attention: the batch split at ``h = B // 2``; half-1's
    fetch runs on the fetch stream while half-2's indexer, top-k and
    lookup run on the current stream; then half-2's fetch; then each half
    finishes as DA (Attn0 before its join).  The halves' pools are views
    of the pool's rows, updated in place, sharing its clock, which ticks
    once after both halves, as in the reference."""
    B = x_norm.shape[0]
    h = B // 2
    if h == 0:
        return _da_or_none(mla_p, idx_p, cfg, x_norm, positions, state,
                           idx_keys, lens, "da", slot_mask, fetch_stream)
    halves = []
    for sl, off in ((slice(0, h), 0), (slice(h, B), h)):
        # the tier (and its block table) stays whole; the half indexes it
        # by batch_offset
        halves.append((sl, state._replace(
            pool=LP.batch_rows(state.pool, sl),
            batch_offset=state.batch_offset + off),
            None if slot_mask is None else slot_mask[sl]))

    looked, fetches = [], []
    for sl, st, sm in halves:
        # half-2's indexer and lookup go on the current stream while
        # half-1's fetch runs on the fetch stream
        pool, lk, stats, ids, rv, K, M_env, _ = _topk_and_lookup(
            idx_p, cfg, x_norm[sl], st, idx_keys[sl], lens[sl], sm)
        looked.append((pool, lk, stats, ids, rv))
        fetches.append(_fork_fetch(st, lk.miss_ids, fetch_stream))

    outs, hit, miss, ovf = [], [], [], []
    for (sl, st, sm), (pool, lk, stats, ids, rv), (rows, fork) in zip(
            halves, looked, fetches):
        out, _ = _finish_attention(mla_p, cfg, x_norm[sl], positions[sl],
                                   pool, lk, ids, rv, rows, fork, K, M_env,
                                   "da", sm)
        outs.append(out)
        hit.append(stats.hits)
        miss.append(stats.misses)
        ovf.append(stats.overflow)
    pool = LP.tick(state.pool)
    return torch.cat(outs, 0), state._replace(pool=pool), ESSStats(
        torch.cat(hit), torch.cat(miss), torch.cat(ovf))


def ess_sparse_attention_staged(mla_p: dict, idx_p: dict, cfg: ArchConfig,
                                x_norm: torch.Tensor, positions: torch.Tensor,
                                state: ESSLayerState, idx_keys: torch.Tensor,
                                lens: torch.Tensor, *, new_rows: torch.Tensor,
                                widx: torch.Tensor,
                                staged_ids_l: torch.Tensor,
                                staged_rows_l: torch.Tensor,
                                staged_scales_l: torch.Tensor | None = None,
                                overlap: str = "da",
                                slot_mask: torch.Tensor | None = None,
                                fetch_stream: torch.cuda.Stream | None = None):
    """One layer of the pipelined round's compute stage: the selection of
    :func:`ess_sparse_attention` (indexer, top-k, pool lookup, admission),
    with each miss row taken from the first of three sources:

    1. the round's own appended rows, ``new_rows [B,Q,D]`` at positions
       ``widx [B,Q]`` (their tier write waits for the commit stage): the
       value a write and a read back through the tier would give;
    2. the slab staged last round, ``staged_ids_l [B,P]`` /
       ``staged_rows_l [B,P,D]`` (a quantized tier's payload and its
       ``staged_scales_l``, dequantized here at miss width);
    3. the synchronous tier gather of the rest, forked onto
       ``fetch_stream`` as DA's fetch is and joined before Attn1, the merge
       and the admission.

    The reference branches on device values (``lax.cond``: any valid miss,
    any miss the slab lacks); a CUDA graph cannot, so every side runs and
    the selects pick the same values.  An all ``-1`` fallback reads nothing
    over the link (the gather writes zeros for negative ids).
    ``overlap="dba"`` runs as DA, as in the reference: the slab already
    takes the fetch off the critical path.

    Returns ``(out, state, stats, plan_sig, (hits, unmatched))``:
    ``plan_sig = (sc_last [B,S], qlens_last [B], slot_of [B,S])`` (the last
    query's indexer scores, its horizon, the post-admission pool map), and
    the slab hits and fallback misses per slot ``[B]`` int32, zero for
    masked slots."""
    B, Q, _ = x_norm.shape
    live = torch.ones((B,), dtype=torch.bool, device=x_norm.device) \
        if slot_mask is None else slot_mask
    pool, lk, stats, ids, req_valid, K, M_env, sc = _topk_and_lookup(
        idx_p, cfg, x_norm, state, idx_keys, lens, slot_mask)

    mvalid = lk.miss_ids >= 0
    D = new_rows.shape[-1]
    own_eq = (lk.miss_ids[:, :, None] == widx[:, None, :]) \
        & (widx >= 0)[:, None, :]                                  # [B,M,Q]
    own = own_eq.any(-1)
    own_rows = new_rows.gather(
        1, TR.first_true(own_eq)[..., None].expand(B, -1, D))      # [B,M,D]
    need = mvalid & ~own
    smatch, srows = TR.match_staged(staged_ids_l, staged_rows_l,
                                    lk.miss_ids, need,
                                    staged_scales_l=staged_scales_l,
                                    out_dtype=new_rows.dtype)
    unmatched = need & ~smatch
    fb, fork = _fork_fetch(state, torch.where(unmatched, lk.miss_ids, -1),
                           fetch_stream if overlap != "none" else None,
                           out_dtype=new_rows.dtype)

    def resolve(fb_rows):
        fetched = torch.where(own[..., None], own_rows,
                              torch.where(smatch[..., None], srows, fb_rows))
        return torch.where(mvalid[..., None], fetched,
                           torch.zeros_like(fetched))

    out, pool = _finish_attention(mla_p, cfg, x_norm, positions, pool, lk,
                                  ids, req_valid, fb, fork, K, M_env,
                                  "da" if overlap == "dba" else overlap,
                                  slot_mask, resolve=resolve)
    pool = LP.tick(pool)
    qlast = lens[:, -1] if lens.dim() == 2 else lens
    liv = live.int()
    return out, state._replace(pool=pool), ESSStats(*stats), \
        (sc[:, -1], qlast, pool.slot_of), \
        (smatch.int().sum(-1) * liv, unmatched.int().sum(-1) * liv)
