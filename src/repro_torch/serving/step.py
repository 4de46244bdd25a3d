"""The serve round's programs (counterpart of ``repro.serving.step``): the
decode round replayed as a CUDA graph over persistent buffers.

The reference compiles each round kind into one donated jitted XLA
program.  The port's counterpart of that program is a **CUDA graph**: the
decode round is captured once over the session's persistent
:class:`~repro_torch.serving.state.EngineState` (caches, ``tok``,
``hidden``, masks) and its :class:`~repro_torch.serving.state.RoundOut`
buffers, and every later round replays it.  A graph replays the kernels
with the addresses of its capture, so every tensor the round reads or
writes is updated in place and never replaced (block tables, ``lens``,
pools, the pinned host tier through its cached UVA pointer).  Capture
needs a round free of host syncs, which the decode step is.

* **decode** — one Q = 1 ESS step over every slot, masked slots writing
  nothing, then greedy token selection; the round writes ``tok``,
  ``hidden``, ``emit_index``, ``lens`` and the packed ``RoundOut`` in
  place.  ``compiled=True`` runs the first round eagerly (building the
  kernels, setting their attributes and caching the UVA pointers and
  plans outside any capture), then captures the round and replays it from
  the second round on; ``compiled=False`` runs the same function eagerly
  every round.  On the CPU only the eager form exists.
* **prefill** — one shape-bucketed chunk for one slot (ragged last chunks
  zero-padded to the bucket and masked by ``n_valid``), which on the last
  chunk selects the first token on the device and promotes the slot.  It
  runs eagerly in both modes and is free of host syncs too: ``slot`` and
  ``n_valid`` are host ints.

Graph replays launch kernels without their wrappers, so the wrappers'
launch counters would stand still: the capture's counts are recorded
(:mod:`repro_torch.kernels.counters`) and added on every replay.

A graph belongs to the state it was captured over, so each session owns
its ``StepPrograms`` (the reference shares its programs process-wide).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import counters
from repro_torch.serving.sampling import greedy
from repro_torch.serving.state import EngineState, RoundOut, promote_slot


def chunk_bucket(ck: int, prefill_chunk: int) -> int:
    """Shape bucket of a (possibly ragged) prefill chunk: the smallest
    power of two >= ``ck``, capped at ``prefill_chunk``."""
    b = 1
    while b < ck:
        b <<= 1
    return min(b, prefill_chunk)


def _decode_round_fn(cfg: ArchConfig) -> Callable:
    """Plain Q = 1 round over the whole slot batch, in place."""
    from repro_torch.serving import engine as E   # engine imports this

    def fn(params: dict, state: EngineState, out: RoundOut) -> None:
        caches = state.caches
        live = state.slot_mask
        o = E.ess_decode(params, cfg, state.tok[:, None],
                         caches.lens[:, None], caches, slot_mask=live)
        t = greedy(o.logits[:, -1])                               # [B]
        caches.lens.copy_(o.caches.lens)
        state.tok.copy_(torch.where(live, t, state.tok))
        state.hidden.copy_(torch.where(live[:, None],
                                       o.stats["hidden"][:, -1],
                                       state.hidden))
        state.emit_index.add_(live.int())
        out.tokens.copy_(torch.where(live, t, 0)[:, None])
        out.n_emit.copy_(live.long())
        out.h2d_rows.copy_(o.stats["misses"].sum().view(1))
        out.hit_rows.copy_(o.stats["hits"].sum().view(1))

    return fn


def _prefill_round_fn(cfg: ArchConfig, last: bool) -> Callable:
    """One bucketed prefill chunk for host-int ``slot``; on the last chunk
    the first token is selected on the device and the slot promoted.
    Returns that token (a device scalar) or None."""
    from repro_torch.serving import engine as E

    def fn(params: dict, state: EngineState, tokens: torch.Tensor,
           slot: int, n_valid: int) -> Optional[torch.Tensor]:
        caches = state.caches
        C = tokens.shape[1]
        positions = caches.lens[slot:slot + 1, None] + torch.arange(
            C, device=tokens.device)[None]
        lg, new, _, hid_last = E.ess_prefill_chunk(
            params, cfg, tokens, positions, caches, slot=slot,
            want_logits=last, n_valid=n_valid)
        caches.lens.copy_(new.lens)
        if not last:
            return None
        t0 = greedy(lg[0, max(n_valid - 1, 0)])
        promote_slot(state, slot, t0, hid_last[0])
        return t0

    return fn


class StepPrograms:
    """The round functions of one session.  ``decode(compiled)`` returns
    the graph-replaying round or the eager one; both take
    ``(params, state, out)`` and update them in place."""

    def __init__(self, cfg: ArchConfig):
        self._cfg = cfg
        self._decode = _decode_round_fn(cfg)
        self._prefill: dict[tuple[int, bool], Callable] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._bound: Optional[tuple] = None
        self._delta: Optional[dict] = None
        self.replays = 0

    def decode(self, compiled: bool) -> Callable:
        return self._graph_round if compiled else self._decode

    def prefill(self, C: int, last: bool) -> Callable:
        fn = self._prefill.get((C, last))
        if fn is None:
            fn = self._prefill[(C, last)] = _prefill_round_fn(self._cfg,
                                                              last)
        return fn

    def _graph_round(self, params: dict, state: EngineState,
                     out: RoundOut) -> None:
        if self._graph is None:
            if not state.caches.lens.is_cuda:
                raise ValueError("compiled=True replays a CUDA graph and "
                                 "needs the session on a CUDA device; "
                                 "pass compiled=False on the CPU")
            self._decode(params, state, out)         # warm-up: a real round
            self._capture(params, state, out)
            return
        if self._bound != (id(params), id(state), id(out)):
            raise ValueError("the decode graph replays the buffers it was "
                             "captured over; a new state needs new "
                             "StepPrograms")
        self._graph.replay()
        counters.add(self._delta)
        self.replays += 1

    def _capture(self, params: dict, state: EngineState,
                 out: RoundOut) -> None:
        """Capture one round on a side stream.  Nothing runs: the round's
        work is recorded, to replay from the next round on.  The
        launches the wrappers counted while recording are taken back and
        kept as the per-replay delta.  Relaxed capture mode: the wrappers
        query their pinned tier's attributes on the host, which the
        global mode refuses; a sync inside the round still fails the
        capture."""
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="relaxed")
            try:
                self._decode(params, state, out)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        self._delta = counters.diff(counters.snapshot(), before)
        counters.restore(before)
        self._graph, self._bound = graph, (id(params), id(state), id(out))
