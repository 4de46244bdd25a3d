"""Device-resident engine state of the serve round (counterpart of
``repro.serving.state``).

:class:`EngineState` holds everything a serve round reads and writes: the
ESS caches, the next input token and the post-final-norm hidden of every
slot, the per-slot sampling knobs and the live / sampling slot masks.
Each field is **one persistent tensor updated in place** (``copy_``,
``fill_``, indexed writes), never replaced: a decode round captured as a
CUDA graph (:mod:`repro_torch.serving.step`) reads and writes the same
addresses on every replay.  The host touches the state only at slot
lifecycle edges (admission, promotion, release), with ``fill_`` of
Python scalars: an indexed assignment of a scalar (``t[slot] = 0``) would
copy it from the host and wait for the card.

Sentinels: ``top_k <= 0`` and ``top_p >= 1`` turn truncation off;
``temperature == 0`` is greedy (``sample_mask`` False).  A pipelined
session (``prefetch_rows > 0``) also holds the staging slab
(:mod:`repro_torch.core.transfer`): ``staged_ids [L,B,P]`` int32 (-1
empty), ``staged_rows [L,B,P,D]`` in the tier's storage dtype and, for a
quantized tier, ``staged_scales [L,B,P,1]`` f16; None otherwise.

:class:`RoundOut` is the round's packed result, the one thing the host
fetches per decode round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cache import latent_cache as LC
from repro_torch.configs.base import ArchConfig
from repro_torch.core import transfer as TR
from repro_torch.serving.scheduler import Request


class EngineState(NamedTuple):
    caches: LC.ESSCaches
    tok: torch.Tensor          # [B] int64  next input token per slot
    hidden: torch.Tensor       # [B,d]      post-final-norm hidden
    temperature: torch.Tensor  # [B] fp32   0 = greedy
    top_k: torch.Tensor        # [B] int32  <= 0 = off
    top_p: torch.Tensor        # [B] fp32   >= 1 = off
    seed: torch.Tensor         # [B] int32  per-request seed
    emit_index: torch.Tensor   # [B] int32  next sampling chain position
    slot_mask: torch.Tensor    # [B] bool   live decode slots
    sample_mask: torch.Tensor  # [B] bool   slots emitting stochastically
    staged_ids: Optional[torch.Tensor] = None      # [L,B,P] int32
    staged_scales: Optional[torch.Tensor] = None   # [L,B,P,1] f16
    staged_rows: Optional[torch.Tensor] = None     # [L,B,P,D]

    @property
    def staged(self) -> Optional[tuple]:
        """The slab as ``ess_decode(staged=)`` takes it, or None."""
        if self.staged_ids is None:
            return None
        return self.staged_ids, self.staged_rows, self.staged_scales


class RoundOut(NamedTuple):
    """The round's result, written in place by the round function and
    fetched as one buffer: ``packed`` is int64 ``[B*Q + B + 2]`` (``+ 3B``
    when pipelined), of which the other fields are views — the emitted
    tokens ``[B,Q]`` (columns ``[0, n_emit)`` valid), ``n_emit [B]`` (0
    for frozen slots), the miss rows the round read from the host tier and
    (port-only) its pool hits, each summed over layers and slots, and a
    pipelined round's prefetch counters per slot (slab rows that served
    misses, misses the fallback gathered, staged rows nobody asked for)."""
    packed: torch.Tensor
    tokens: torch.Tensor       # [B,Q]
    n_emit: torch.Tensor       # [B]
    h2d_rows: torch.Tensor     # [1]
    hit_rows: torch.Tensor     # [1]
    pf_hits: Optional[torch.Tensor] = None     # [B]
    pf_misses: Optional[torch.Tensor] = None   # [B]
    pf_wasted: Optional[torch.Tensor] = None   # [B]


def init_round_out(num_slots: int, q: int, device, *,
                   prefetch: bool = False) -> RoundOut:
    B, n = num_slots, num_slots * q
    m = n + B + 2
    packed = torch.zeros((m + (3 * B if prefetch else 0),),
                         dtype=torch.int64, device=device)
    pf = (packed[m:m + B], packed[m + B:m + 2 * B],
          packed[m + 2 * B:]) if prefetch else ()
    return RoundOut(packed, packed[:n].view(B, q), packed[n:n + B],
                    packed[n + B:n + B + 1], packed[n + B + 1:m], *pf)


def init_engine_state(cfg: ArchConfig, caches: LC.ESSCaches,
                      num_slots: int, *,
                      prefetch_rows: int = 0) -> EngineState:
    """The state of a ``num_slots`` session over ``caches``; with
    ``prefetch_rows > 0``, a disarmed slab of that many rows per layer and
    slot."""
    dev = caches.lens.device
    B = num_slots
    slab = {}
    if prefetch_rows > 0:
        hs = caches.host_scales
        ids, rows, scales = TR.empty_slab(
            caches.host_latent.shape[0], B, prefetch_rows,
            caches.host_latent.shape[-1], caches.host_latent.dtype,
            None if hs is None else hs.dtype, device=dev)
        slab = dict(staged_ids=ids, staged_rows=rows, staged_scales=scales)
    return EngineState(
        caches=caches,
        tok=torch.zeros((B,), dtype=torch.int64, device=dev),
        hidden=torch.zeros((B, cfg.d_model), dtype=cfg.param_dtype,
                           device=dev),
        temperature=torch.zeros((B,), dtype=torch.float32, device=dev),
        top_k=torch.zeros((B,), dtype=torch.int32, device=dev),
        top_p=torch.ones((B,), dtype=torch.float32, device=dev),
        seed=torch.zeros((B,), dtype=torch.int32, device=dev),
        emit_index=torch.zeros((B,), dtype=torch.int32, device=dev),
        slot_mask=torch.zeros((B,), dtype=torch.bool, device=dev),
        sample_mask=torch.zeros((B,), dtype=torch.bool, device=dev),
        **slab)


def admit_slot(state: EngineState, slot: int, req: Request) -> EngineState:
    """Install a request's sampling knobs into its slot (a host-side edge;
    the slot stays frozen until its last prefill chunk promotes it)."""
    state.temperature[slot].fill_(float(req.temperature))
    state.top_k[slot].fill_(0 if req.top_k is None else int(req.top_k))
    state.top_p[slot].fill_(1.0 if req.top_p is None else float(req.top_p))
    state.seed[slot].fill_(int(req.sample_seed))
    state.emit_index[slot].fill_(0)
    state.sample_mask[slot].fill_(bool(req.sampling))
    return state


def promote_slot(state: EngineState, slot: int, tok,
                 hidden: torch.Tensor) -> EngineState:
    """Flip a freshly prefilled slot into the decode batch: install the
    first token (a device scalar, or a Python int: a migrated request's)
    and the hidden (on the device, or pinned on the host: copied without
    waiting), arm the chain at emission index 1 and unfreeze the slot."""
    if isinstance(tok, torch.Tensor):
        state.tok[slot].copy_(tok)
    else:
        state.tok[slot].fill_(int(tok))
    state.hidden[slot].copy_(hidden, non_blocking=True)
    state.emit_index[slot].fill_(1)
    state.slot_mask[slot].fill_(True)
    return state


def release_slot(state: EngineState, slot: int) -> EngineState:
    """Freeze a finished or preempted slot (a host-side edge).  The cache
    tier's cleanup (pages, pools, lens) is
    :func:`repro_torch.cache.latent_cache.reset_slot` / ``unmap_slot``.
    The slot's staged ids are cancelled with it: a surviving one would
    serve the previous occupant's row to the next."""
    state.slot_mask[slot].fill_(False)
    state.sample_mask[slot].fill_(False)
    state.temperature[slot].fill_(0.0)
    state.emit_index[slot].fill_(0)
    if state.staged_ids is not None:
        state.staged_ids[:, slot].fill_(-1)
    return state
