"""Two-Batch Overlap (counterpart of ``repro.serving.tbo``; the paper's
Table 1: "Two-Batch Overlap").

A decode or verify step splits its batch at ``B // 2`` into two halves
that step independently: half A on the current stream, half B forked onto
a stream of its own and joined before the step returns, so one half's
host fetches and MoE overlap the other half's compute.  The reference
states this as one jitted program whose independent halves XLA's
scheduler interleaves; here the fork and the join, recorded inside the
round's graph capture, make the halves two parallel branches of the CUDA
graph.  Each half's DA / DBA miss fetches go on its own fetch stream
(:class:`Streams`).

The port's idiom is in place, so a split is a set of **views**: ``lens``,
indexer keys, pool rows and block-table rows are sliced; a paged tier and
its scale plane stay whole (each slot writes only its own pages), a dense
tier is sliced on its batch axis.  Each half's pools keep their own LRU
clock, as the reference's halves carry their own copy of ``step``: half A
ticks the pool's clock in place, half B a copy of it, and the merge keeps
half A's.  Both advance one tick per layer, so the clock and every stamp
equal the reference's.  The merge copies back only what a step rebinds:
``lens``.

Each half dispatches its own tokens through the MoE, with its own
capacity ``ceil(T_half * K / E * cf)``, as the reference's halves do; a
TBO round therefore reads the experts' weights twice.

A pipelined round's staging slab splits along its slot axis as views
(``[:, :h]``, ``[:, h:]``): each half commits, plans and lands its own
slab half in place, its gather on its own fetch stream.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.cache import latent_cache as LC
from repro_torch.core import lru_pool as LP
from repro_torch.core.overlap import Fork, side_stream


class Streams(NamedTuple):
    """The side streams of a step, made once, outside any graph capture
    (all None on the CPU)."""
    fetch_a: Optional[torch.cuda.Stream]   # half A's (or the whole
                                           # batch's) miss fetches
    half_b: Optional[torch.cuda.Stream]    # half B's step
    fetch_b: Optional[torch.cuda.Stream]   # half B's miss fetches


def make_streams(device) -> Streams:
    return Streams(side_stream(device), side_stream(device),
                   side_stream(device))


def split_caches(caches: LC.ESSCaches, half: int
                 ) -> tuple[LC.ESSCaches, LC.ESSCaches]:
    """Views of ``caches`` for batch rows ``[0, half)`` and ``[half, B)``;
    the second half's pools get a copy of each pool's clock."""
    paged = caches.block_tables is not None
    hs = caches.host_scales

    def cut(sl: slice, own_clock: bool) -> LC.ESSCaches:
        return caches._replace(
            lens=caches.lens[sl],
            host_latent=caches.host_latent if paged
            else caches.host_latent[:, sl],
            ikeys=[k[sl] for k in caches.ikeys],
            pools=[LP.batch_rows(p, sl)._replace(step=p.step.clone())
                   if own_clock else LP.batch_rows(p, sl)
                   for p in caches.pools],
            block_tables=caches.block_tables[sl] if paged else None,
            host_scales=hs if hs is None or paged else hs[:, sl])

    return cut(slice(0, half), False), cut(slice(half, None), True)


def merge_caches(caches: LC.ESSCaches, caches_a: LC.ESSCaches,
                 caches_b: LC.ESSCaches) -> LC.ESSCaches:
    """Reconcile the halves' step results into ``caches``, whose tensors
    the halves' views already updated in place: ``lens`` is copied back
    (the one field a step rebinds); half B's clock copies are dropped.
    Returns ``caches``."""
    caches.lens.copy_(torch.cat([caches_a.lens, caches_b.lens]))
    return caches


def split_slab(staged: Optional[tuple], half: int
               ) -> tuple[dict, dict]:
    """A slab ``(ids, rows, scales)`` split on its slot axis into views,
    as each half's ``staged=`` keyword (none without a slab)."""
    if staged is None:
        return {}, {}
    return tuple({"staged": tuple(None if t is None else t[:, sl]
                                  for t in staged)}
                 for sl in (slice(0, half), slice(half, None)))


def two_batch_step(step_fn: Callable, params: dict, cfg, tokens, positions,
                   caches_a: LC.ESSCaches, caches_b: LC.ESSCaches, *,
                   slot_mask: Optional[torch.Tensor] = None,
                   streams: Optional[Streams] = None,
                   staged: Optional[tuple] = None):
    """tokens / positions [B,Q] split at ``B // 2`` over pre-split caches
    (:func:`split_caches`).  ``step_fn(params, cfg, tokens, positions,
    caches, slot_mask=..., fetch_stream=...)`` steps one half (e.g.
    ``engine.ess_decode``); ``slot_mask`` [B] splits alongside, and a
    pipelined round's slab ``staged`` (passed on as ``staged=``) on its
    slot axis.  Half B runs on ``streams.half_b`` and is joined before
    this returns.

    Returns ``(logits [B,Q,V], caches_a', caches_b', stats)``, ``stats``
    the halves' concatenated along the batch."""
    h = tokens.shape[0] // 2
    streams = streams or Streams(None, None, None)
    sm_a = sm_b = None
    if slot_mask is not None:
        sm_a, sm_b = slot_mask[:h], slot_mask[h:]
    kw_a, kw_b = split_slab(staged, h)
    crossing = [tokens, positions] + [p.step for p in caches_b.pools]
    if slot_mask is not None:
        crossing.append(slot_mask)
    with Fork(streams.half_b, *crossing) as fork_b:
        out_b = step_fn(params, cfg, tokens[h:], positions[h:], caches_b,
                        slot_mask=sm_b, fetch_stream=streams.fetch_b, **kw_b)
    out_a = step_fn(params, cfg, tokens[:h], positions[:h], caches_a,
                    slot_mask=sm_a, fetch_stream=streams.fetch_a, **kw_a)
    fork_b.join()
    logits = torch.cat([out_a.logits, out_b.logits])
    stats = {k: torch.cat([out_a.stats[k], out_b.stats[k]])
             for k in out_a.stats}
    return logits, out_a.caches, out_b.caches, stats


def tbo_step(step_fn: Callable, params: dict, cfg, tokens, positions,
             caches: LC.ESSCaches, *,
             slot_mask: Optional[torch.Tensor] = None,
             streams: Optional[Streams] = None,
             staged: Optional[tuple] = None):
    """Split, step both halves, merge: the step-level TBO block of the
    serve round.  Returns ``(logits [B,Q,V], caches, stats)``."""
    ca, cb = split_caches(caches, tokens.shape[0] // 2)
    logits, ca2, cb2, stats = two_batch_step(
        step_fn, params, cfg, tokens, positions, ca, cb,
        slot_mask=slot_mask, streams=streams, staged=staged)
    return logits, merge_caches(caches, ca2, cb2), stats
