"""The device-side **Sparse Memory Pool** with LRU eviction/admission
(paper section 3.2; counterpart of ``repro.core.lru_pool``).

Per (layer, sequence) the pool holds ``P`` latent rows; the inverse map
``slot_of`` makes a lookup O(K) gathers.  State, batch-leading:

* ``data     [B, P, D]``  resident latent rows
* ``ids      [B, P]``     token position in each slot (-1 empty)
* ``last_use [B, P]``     LRU step stamp (-1 empty)
* ``slot_of  [B, S]``     position -> slot (-1 not resident)
* ``step     []``         monotone step counter
* ``evicted  [B]``        resident rows evicted so far (port-only counter)

Unlike the reference's pure functions, :func:`lookup`, :func:`admit` and
:func:`tick` **update the pool's tensors in place** and return the same
``PoolState``.  Every transition is fixed-shape and sync-free on the card:
the reference's out-of-range ``mode="drop"`` writes become writes whose
dropped entries are redirected onto a harmless duplicate (see
:func:`put_drop`), never clipped onto a live slot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (is_dtensor, local_call,
                                              put_drop_sharded)
from repro_torch.models.mla import topk_desc


class PoolState(NamedTuple):
    data: torch.Tensor        # [B, P, D]
    ids: torch.Tensor         # [B, P] int64
    last_use: torch.Tensor    # [B, P] int64
    slot_of: torch.Tensor     # [B, S] int64
    step: torch.Tensor        # [] int64
    evicted: torch.Tensor     # [B] int64


class Lookup(NamedTuple):
    slot: torch.Tensor        # [B, K] pool slot of each request (-1 miss)
    hit: torch.Tensor         # [B, K] bool
    miss_ids: torch.Tensor    # [B, M] requested-but-absent ids (-1 pad)
    miss_rank: torch.Tensor   # [B, K] rank of each miss among misses (or big)
    n_miss: torch.Tensor      # [B] true miss count (incl. overflow)


class PoolStats(NamedTuple):
    hits: torch.Tensor        # [B]
    misses: torch.Tensor      # [B]
    overflow: torch.Tensor    # [B] misses beyond the M envelope (dropped)


def init_pool(batch: int, pool_entries: int, max_seq: int, dim: int,
              dtype=torch.bfloat16, device=None) -> PoolState:
    """An empty pool on ``device`` (the card by default)."""
    device = resolve_device(device)
    i64 = dict(dtype=torch.int64, device=device)
    return PoolState(
        data=torch.zeros((batch, pool_entries, dim), dtype=dtype,
                         device=device),
        ids=torch.full((batch, pool_entries), -1, **i64),
        last_use=torch.full((batch, pool_entries), -1, **i64),
        slot_of=torch.full((batch, max_seq), -1, **i64),
        step=torch.zeros((), **i64),
        evicted=torch.zeros((batch,), **i64))


def put_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> None:
    """In place ``dst[b, idx[b,j]] = vals[b,j]`` where ``keep[b,j]``; other
    entries write nothing (the reference's ``.at[...].set(mode="drop")``).

    dst [B, N, ...], idx [B, M], vals [B, M, ...] (or broadcastable, or a
    Python scalar: no host-to-device copy), keep [B, M].  Kept indices of
    one row must be distinct and in range.  A dropped entry is redirected
    onto its row's first kept entry with that entry's value (an identical
    duplicate write), or, in a row with nothing kept, onto position 0 with
    its current value — so no host sync and no write to a live position.
    A DTensor ``dst`` (the dry run) is written shard by shard
    (:func:`~repro_torch.distributed.sharding.put_drop_sharded`)."""
    if is_dtensor(dst):
        return put_drop_sharded(dst, idx, vals, keep, put_drop)
    B, M = idx.shape
    if not isinstance(vals, torch.Tensor):
        vals = dst.new_full((1, 1) + dst.shape[2:], vals)
    vals = vals.expand(B, M, *dst.shape[2:]).to(dst.dtype)
    first = keep.to(torch.int8).argmax(dim=1, keepdim=True)      # [B,1]
    any_kept = keep.any(dim=1, keepdim=True)
    idx_f = idx.gather(1, first)
    bi = torch.arange(B, device=idx.device)
    val_f = vals[bi, first[:, 0]][:, None]                       # [B,1,...]
    cur0 = dst[:, :1]
    extra = (1,) * (dst.dim() - 2)
    tidx = torch.where(keep, idx, torch.where(any_kept, idx_f, 0))
    tval = torch.where(keep.view(B, M, *extra), vals,
                       torch.where(any_kept.view(B, 1, *extra), val_f, cur0))
    dst[bi[:, None], tidx] = tval


def lookup(pool: PoolState, req_ids: torch.Tensor, req_valid: torch.Tensor,
           max_misses: int, *, slot_mask: torch.Tensor | None,
           dedup: bool = True) -> tuple[PoolState, Lookup, PoolStats]:
    """Resolve requested cache ids against the pool (touches hit stamps in
    place).  req_ids [B,K] score-descending, req_valid [B,K]; returns a miss
    buffer of fixed width ``max_misses``.  ``slot_mask`` [B] (required,
    keyword-only; ``None`` = every row live) gates frozen rows.  ``dedup``
    makes duplicate requests share one miss-buffer entry (Q>1 steps).
    A pool of DTensors (several data ranks) runs on each rank's own rows
    (:func:`~repro_torch.distributed.sharding.local_call`), as every
    transition here does."""
    if is_dtensor(pool.ids):
        return local_call(lookup, pool, req_ids, req_valid, max_misses,
                          slot_mask=slot_mask, dedup=dedup)
    B, K = req_ids.shape
    if slot_mask is not None:
        req_valid = req_valid & slot_mask[:, None]
    safe_ids = req_ids.clamp(0, pool.slot_of.shape[1] - 1)
    slot = pool.slot_of.gather(1, safe_ids)                      # [B,K]
    hit = (slot >= 0) & req_valid
    miss = ~hit & req_valid

    # touch hits: last_use[b, slot] = max(last_use, step) (misses add -1)
    pool.last_use.scatter_reduce_(
        1, torch.where(hit, slot, 0),
        torch.where(hit, pool.step, torch.full_like(slot, -1)),
        reduce="amax")

    if dedup:
        eq = req_ids[:, :, None] == req_ids[:, None, :]          # [B,K,K]
        earlier = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                        device=req_ids.device), -1)[None]
        dup = miss & (eq & earlier & miss[:, None, :]).any(-1)
        unique_miss = miss & ~dup
        rank_u = unique_miss.long().cumsum(1) - 1
        # rank of request j = rank of the unique miss sharing its id (at
        # most one per id, so the sum selects it)
        rank = ((eq & unique_miss[:, None, :]).long()
                * torch.where(unique_miss, rank_u, 0)[:, None, :]).sum(-1)
    else:
        unique_miss = miss
        rank = miss.long().cumsum(1) - 1
    rank = torch.where(miss, rank, K + max_misses)
    scat = torch.where(rank < max_misses, rank, max_misses)
    miss_ids = torch.full((B, max_misses + 1), -1, dtype=torch.int64,
                          device=req_ids.device)
    miss_ids.scatter_(1, scat, req_ids.long())
    miss_ids = miss_ids[:, :max_misses]

    n_miss = unique_miss.long().sum(1)
    stats = PoolStats(hits=hit.long().sum(1), misses=n_miss,
                      overflow=(n_miss - max_misses).clamp_min(0))
    return pool, Lookup(slot, hit, miss_ids, rank, n_miss), stats


def admit(pool: PoolState, miss_ids: torch.Tensor, rows: torch.Tensor, *,
          slot_mask: torch.Tensor | None,
          protect_slots: torch.Tensor | None = None) -> PoolState:
    """LRU-evict the coldest slots and install the fetched rows, in place.

    miss_ids [B,M] (-1 padding ignored), rows [B,M,D].  ``slot_mask``
    (required, keyword-only) voids masked rows' admissions.  A miss
    envelope wider than the pool admits its first ``P`` entries."""
    if is_dtensor(pool.ids):
        return local_call(admit, pool, miss_ids, rows, slot_mask=slot_mask,
                          protect_slots=protect_slots)
    B, M = miss_ids.shape
    if slot_mask is not None:
        miss_ids = torch.where(slot_mask[:, None], miss_ids, -1)
    P = pool.ids.shape[1]
    if M > P:
        miss_ids, rows = miss_ids[:, :P], rows[:, :P]
        M = P
    valid = miss_ids >= 0

    score = pool.last_use
    if protect_slots is not None:
        score = score.clone()
        put_drop(score, protect_slots.clamp_min(0),
                 torch.iinfo(torch.int32).max, protect_slots >= 0)
    # coldest M slots; empty slots (-1) first, lowest slot among equal stamps
    evict = topk_desc(-score, M)                                  # [B,M]

    old_ids = pool.ids.gather(1, evict)
    old_valid = (old_ids >= 0) & valid
    put_drop(pool.slot_of, old_ids.clamp_min(0), -1, old_valid)
    put_drop(pool.slot_of, miss_ids.clamp_min(0), evict, valid)
    put_drop(pool.ids, evict, miss_ids, valid)
    put_drop(pool.last_use, evict, pool.step, valid)
    put_drop(pool.data, evict, rows, valid)
    pool.evicted.add_(old_valid.long().sum(1))
    return pool


def batch_rows(pool: PoolState, rows: slice) -> PoolState:
    """Views of the pool's batch ``rows`` (a split batch's half), sharing
    the pool's clock; in-place updates through them update the pool."""
    return pool._replace(**{f: getattr(pool, f)[rows]
                            for f in pool._fields if f != "step"})


def tick(pool: PoolState) -> PoolState:
    if is_dtensor(pool.step):
        pool.step.to_local().add_(1)       # each rank's copy of the clock
        return pool
    pool.step.add_(1)
    return pool


def invalidate_beyond(pool: PoolState, lens: torch.Tensor) -> PoolState:
    """Drop pool entries for positions ``>= lens[b]``, in place (a rollback:
    those positions will be written again with other content, so their
    pool rows must not survive).  Clears the forward map (``ids`` /
    ``last_use``) and the inverse map (``slot_of``) alike, so it is
    idempotent; a row whose ``lens`` did not move keeps its entries."""
    if is_dtensor(pool.ids):
        return local_call(invalidate_beyond, pool, lens)
    stale = pool.ids >= lens[:, None]                            # [B,P]
    pool.ids.masked_fill_(stale, -1)
    pool.last_use.masked_fill_(stale, -1)
    pos = torch.arange(pool.slot_of.shape[1], device=lens.device)
    pool.slot_of.masked_fill_(pos[None, :] >= lens[:, None], -1)
    return pool


def check_consistent(pool: PoolState) -> bool:
    """Host-side invariant check (tests / debugging): forward map ``ids``
    and inverse map ``slot_of`` mirror each other exactly."""
    ids = pool.ids.cpu().numpy()
    slot_of = pool.slot_of.cpu().numpy()
    last_use = pool.last_use.cpu().numpy()
    B, P = ids.shape
    for b in range(B):
        res = ids[b][ids[b] >= 0]
        if len(res) != len(np.unique(res)):
            return False                     # duplicate resident position
        for s in range(P):
            if ids[b, s] >= 0 and slot_of[b, ids[b, s]] != s:
                return False                 # forward without inverse
            if ids[b, s] < 0 and last_use[b, s] >= 0:
                return False                 # empty slot with live stamp
        for pos in np.nonzero(slot_of[b] >= 0)[0]:
            if ids[b, slot_of[b, pos]] != pos:
                return False                 # inverse without forward
    return True


def gather_resident(pool: PoolState, slot: torch.Tensor, hit: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather hit rows [B,K,D] from the pool (miss rows zero)."""
    if is_dtensor(pool.ids):
        return local_call(gather_resident, pool, slot, hit)
    safe = torch.where(hit, slot, 0)
    rows = pool.data.gather(
        1, safe[..., None].expand(*safe.shape, pool.data.shape[-1]))
    return torch.where(hit[..., None], rows, torch.zeros_like(rows)), hit


def pool_entries_for(ratio: float, context_len: int, topk: int,
                     min_entries: int) -> int:
    """Sparse-Memory-Ratio -> pool size, floored at max(topk, min(6.4K, S))."""
    p = int(ratio * context_len)
    return max(p, topk, min(min_entries, context_len))
