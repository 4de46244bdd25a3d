"""The staging slab of the pipelined round and its host-side orchestrator
(counterpart of ``repro.core.transfer``).

A pipelined serve round is three stages, **plan -> compute -> commit**:
round ``N`` sources its miss rows from a slab staged during round ``N-1``,
and plans and stages round ``N+1``'s while it finishes.  The slab:

* ``staged_ids  [L, B, P]`` int32: the sequence positions staged per layer
  and slot (``-1`` = empty or cancelled);
* ``staged_rows [L, B, P, D]``: the tier's rows at those positions, in the
  tier's storage dtype (a quantized tier's payload, not widened);
* ``staged_scales [L, B, P, 1]`` f16: a quantized tier's scales, or None.

The reference double-buffers the slab through XLA's buffer donation.  On
the card each leaf is **one persistent tensor updated in place**, so that
a round captured as a CUDA graph reads and writes the same addresses on
every replay: the round builds the next slab in temporaries, its gather
forked onto the fetch stream, and copies it into the leaves after the
join (:func:`repro_torch.serving.engine.ess_decode`).

Prediction is indexer-driven: the last query's indexer scores of round
``N`` rank the positions that are in its horizon and not pool-resident,
and the ``P`` best are staged (:func:`plan_prefetch`).  A wrong guess is
never a wrong value: the compute stage serves a miss from the slab only
where the ids match (:func:`match_staged`) and gathers the rest
synchronously, so a pipelined stream equals the synchronous one.

:func:`empty_slab`, :func:`plan_prefetch` and :func:`match_staged` are
fixed-shape tensor ops, free of host syncs.  :class:`TransferEngine` is
what the serve session drives at stage and slot-lifecycle edges, all in
place and without host syncs.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import compression as cmp
from repro_torch.models.mla import topk_desc

# lax.top_k's masked value in the reference's plan: float32's lowest
_NEG = torch.finfo(torch.float32).min


def empty_slab(num_layers: int, num_slots: int, prefetch_rows: int,
               dim: int, dtype, scale_dtype=None, device="cpu"
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """A disarmed slab ``(ids, rows, scales)``: no id staged (-1), zero
    rows; ``scales`` ``[L,B,P,1]`` zeros of ``scale_dtype`` for a quantized
    tier (rows then hold its payload dtype), None for a raw one."""
    shape = (num_layers, num_slots, prefetch_rows)
    scales = None if scale_dtype is None else torch.zeros(
        (*shape, 1), dtype=scale_dtype, device=device)
    return (torch.full(shape, -1, dtype=torch.int32, device=device),
            torch.zeros((*shape, dim), dtype=dtype, device=device), scales)


def plan_prefetch(sc_last: torch.Tensor, qlens_last: torch.Tensor,
                  slot_of: torch.Tensor, live: torch.Tensor, topk: int,
                  prefetch_rows: int) -> torch.Tensor:
    """One plan over rows of ``sc_last [N,S]`` (the last query's indexer
    scores; the round stacks its layers' slots into ``N = L*B``):
    ``qlens_last [N]`` its horizon, ``slot_of [N,S]`` the post-admission
    pool map, ``live [N]`` the slot gate.  Returns ``pred [N,P]`` int32,
    -1 padded: the ``P`` highest-scored positions in the horizon that are
    not pool-resident, in ``lax.top_k``'s order (the lowest index first
    among equal scores; the ReLU'd indexer gives many exact zeros).
    ``topk`` is unused, as in the reference (K never truncates the
    plan)."""
    del topk
    N, S = sc_last.shape
    pos = torch.arange(S, device=sc_last.device)
    cand = (pos[None] < qlens_last[:, None]) & (slot_of < 0) \
        & live[:, None]
    masked = torch.where(cand, sc_last.float(),
                         torch.full_like(sc_last, _NEG, dtype=torch.float32))
    k = min(prefetch_rows, S)
    top = topk_desc(masked, k)                                    # [N,k]
    val = masked.gather(1, top)
    pred = torch.where(val > _NEG / 2, top, -1).to(torch.int32)
    if k < prefetch_rows:
        pred = torch.nn.functional.pad(pred, (0, prefetch_rows - k),
                                       value=-1)
    return pred


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as its bytes when it holds a one-byte float (fp8 payload),
    which ``gather`` and ``where`` do not take; otherwise ``t``.  Slab rows
    are only moved, never computed on, so the bytes are the values."""
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn,
                                              torch.float8_e5m2) else t


def first_true(eq: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none):
    ``jnp.argmax`` of a bool mask.  The mask is cast first; torch's
    ``argmax`` returns the first of equal maxima."""
    return eq.to(torch.uint8).argmax(-1)


def match_staged(staged_ids_l: torch.Tensor, staged_rows_l: torch.Tensor,
                 miss_ids: torch.Tensor, need: torch.Tensor,
                 staged_scales_l: torch.Tensor | None = None,
                 out_dtype=torch.bfloat16
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a round's misses from one layer's slab.

    ``staged_ids_l [B,P]`` / ``staged_rows_l [B,P,D]`` (and a quantized
    tier's ``staged_scales_l [B,P,1]``); ``miss_ids [B,M]``, the lookup's
    miss buffer; ``need [B,M]``, the misses that need tier rows.  Returns
    ``(matched [B,M], rows [B,M,D])``: matched rows carry the staged values
    (dequantized at miss width to ``out_dtype`` for a quantized tier, as
    the synchronous gather would give them), the others are zero."""
    eq = (miss_ids[:, :, None] == staged_ids_l[:, None, :]) \
        & (staged_ids_l >= 0)[:, None, :] & need[:, :, None]      # [B,M,P]
    matched = eq.any(-1)
    idx = first_true(eq)                                          # [B,M]
    D = staged_rows_l.shape[-1]
    rows = raw_bytes(staged_rows_l).gather(
        1, idx[..., None].expand(*idx.shape, D)).view(staged_rows_l.dtype)
    if staged_scales_l is not None:
        scales = staged_scales_l.gather(1, idx[..., None])        # [B,M,1]
        rows = cmp.dequantize_rows(rows, scales, out_dtype)
    return matched, torch.where(matched[..., None], rows,
                                torch.zeros_like(rows))


class TransferEngine:
    """What the serve session does with the slab at stage and slot
    lifecycle edges.  The transfers themselves run inside the round
    (gathered on the fetch stream, landed before it ends); these methods
    work on an :class:`~repro_torch.serving.state.EngineState` in place,
    with no host sync:

    * :meth:`issue_stage` disarms the whole slab (``fill_(-1)``,
      ``zero_()``): nothing staged, the next round plans from scratch;
    * :meth:`await_staged` is the ``(ids, rows, scales)`` the next round's
      compute stage reads;
    * :meth:`commit` folds a round's prefetch counters, which arrived in
      the round's one host fetch, into the report;
    * :meth:`invalidate_slot` / :meth:`truncate_slot` cancel staged ids
      whose rows a release, abort or stop-token rollback invalidated (a
      stale id would serve another occupant's row, or a dead draft's)."""

    def __init__(self, num_layers: int, num_slots: int, prefetch_rows: int,
                 dim: int, dtype, scale_dtype=None):
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.prefetch_rows = prefetch_rows
        self.dim = dim
        self.dtype = dtype
        self.scale_dtype = scale_dtype

    def issue_stage(self, state):
        state.staged_ids.fill_(-1)
        state.staged_rows.zero_()
        if state.staged_scales is not None:
            state.staged_scales.zero_()
        return state

    def await_staged(self, state):
        return state.staged_ids, state.staged_rows, state.staged_scales

    def commit(self, report, pf_hits, pf_misses, pf_wasted) -> None:
        report.prefetch_hits += int(pf_hits)
        report.prefetch_misses += int(pf_misses)
        report.prefetch_wasted_rows += int(pf_wasted)

    def invalidate_slot(self, state, slot: int):
        if state.staged_ids is not None:
            state.staged_ids[:, slot].fill_(-1)
        return state

    def truncate_slot(self, state, slot: int, new_len):
        """Cancel the slot's staged ids at positions ``>= new_len``, which
        may be a device scalar (no host sync)."""
        if state.staged_ids is not None:
            col = state.staged_ids[:, slot]                       # [L,P]
            col.copy_(torch.where(col >= new_len, -1, col))
        return state
