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
``temperature == 0`` is greedy (``sample_mask`` False).  The pipelined
round's staged-slab fields are not ported and stay ``None``.

:class:`RoundOut` is the round's packed result, the one thing the host
fetches per decode round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cache import latent_cache as LC
from repro_torch.configs.base import ArchConfig
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
    staged_ids: Optional[torch.Tensor] = None
    staged_scales: Optional[torch.Tensor] = None
    staged_rows: Optional[torch.Tensor] = None


class RoundOut(NamedTuple):
    """The round's result, written in place by the round function and
    fetched as one buffer: ``packed`` is int64 ``[B*Q + B + 2]``, of which
    the other fields are views — the emitted tokens ``[B,Q]`` (columns
    ``[0, n_emit)`` valid), ``n_emit [B]`` (0 for frozen slots), the miss
    rows the round read from the host tier and (port-only) its pool hits,
    each summed over layers and slots."""
    packed: torch.Tensor
    tokens: torch.Tensor       # [B,Q]
    n_emit: torch.Tensor       # [B]
    h2d_rows: torch.Tensor     # [1]
    hit_rows: torch.Tensor     # [1]


def init_round_out(num_slots: int, q: int, device) -> RoundOut:
    B, n = num_slots, num_slots * q
    packed = torch.zeros((n + B + 2,), dtype=torch.int64, device=device)
    return RoundOut(packed, packed[:n].view(B, q), packed[n:n + B],
                    packed[n + B:n + B + 1], packed[n + B + 1:])


def init_engine_state(cfg: ArchConfig, caches: LC.ESSCaches,
                      num_slots: int) -> EngineState:
    dev = caches.lens.device
    B = num_slots
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
        sample_mask=torch.zeros((B,), dtype=torch.bool, device=dev))


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


def promote_slot(state: EngineState, slot: int, tok: torch.Tensor,
                 hidden: torch.Tensor) -> EngineState:
    """Flip a freshly prefilled slot into the decode batch: install the
    first token (a device scalar) and the hidden, arm the chain at
    emission index 1 and unfreeze the slot."""
    state.tok[slot].copy_(tok)
    state.hidden[slot].copy_(hidden)
    state.emit_index[slot].fill_(1)
    state.slot_mask[slot].fill_(True)
    return state


def release_slot(state: EngineState, slot: int) -> EngineState:
    """Freeze a finished or preempted slot (a host-side edge).  The cache
    tier's cleanup (pages, pools, lens) is
    :func:`repro_torch.cache.latent_cache.reset_slot` / ``unmap_slot``."""
    state.slot_mask[slot].fill_(False)
    state.sample_mask[slot].fill_(False)
    state.temperature[slot].fill_(0.0)
    state.emit_index[slot].fill_(0)
    return state
