"""The serve round's programs (counterpart of ``repro.serving.step``): the
decode and speculative rounds replayed as CUDA graphs over persistent
buffers.

The reference compiles each round kind into one donated jitted XLA
program.  The port's counterpart of that program is a **CUDA graph**: a
round is captured once over the session's persistent
:class:`~repro_torch.serving.state.EngineState` (caches, ``tok``,
``hidden``, knobs, masks) and its :class:`~repro_torch.serving.state
.RoundOut` buffers, and every later round of that kind replays it.  A
graph replays the kernels with the addresses of its capture, so every
tensor a round reads or writes is updated in place and never replaced
(block tables, ``lens``, pools, the pinned host tier through its cached
UVA pointer).  Capture needs a round free of host syncs, which every
round is.

* **decode** — one Q = 1 ESS step over every slot, masked slots writing
  nothing, then token selection; writes ``tok``, ``hidden``,
  ``emit_index``, ``lens`` and the packed ``RoundOut`` in place.
* **spec** — the MTP round: ``mtp_draft``, the Q = depth + 1 verify step,
  acceptance and the in-place rollback (``mtp.speculative_step``), then
  emission packing: greedy slots emit the accepted prefix and the bonus
  token, sampling slots (drafts force-rejected) one token drawn from the
  verify step's first-position logits with the key the Q = 1 round would
  fold.
* **prefill** — one shape-bucketed chunk for one slot (ragged last chunks
  zero-padded to the bucket and masked by ``n_valid``), which on the last
  chunk selects the first token on the device (emission index 0) and
  promotes the slot.  It runs eagerly in both modes and is free of host
  syncs too: ``slot`` and ``n_valid`` are host ints.

Each round kind has a **greedy and a sampling variant**.  The reference
skips its sampler with a device-side ``lax.cond`` when no live slot
samples; a graph cannot branch on a device value without a sync, and the
host knows from the scheduler which live requests sample, so the session
picks the variant and each variant is its own graph.  The variants share
one graph memory pool (they never run at once, and nothing a capture
allocates outlives its round).  ``compiled=True`` runs a variant's first
round eagerly (building the kernels, setting their attributes and caching
the UVA pointers and plans outside any capture), then captures it and
replays it from its second round on; ``compiled=False`` runs the same
functions eagerly every round.  On the CPU only the eager form exists.

Both round kinds step the model through one raw step (the reference's
``_make_raw_step``): ``ess_decode``, or with ``tbo`` the Two-Batch
Overlap composition (:mod:`repro_torch.serving.tbo`), whose half B runs
on a stream of its own.  The DA / DBA miss fetches fork onto fetch
streams.

A pipelined session's state holds the staging slab
(:mod:`repro_torch.core.transfer`); both round kinds then read it in
each layer and plan the next one after the layer loop, its gather forked
onto the fetch stream beside the final norm, the unembedding and the token
selection, and joined before the slab's rows are copied into place at the
end of the round (a TBO half lands its own before its join).  The round's
prefetch counters ride in ``RoundOut``, in the round's one fetch.  These side streams are made once, by :class:`StepPrograms`,
outside any capture; each fork inside a round is joined inside it, so a
captured round's side streams are parallel branches of its graph.

Graph replays launch kernels without their wrappers, so the wrappers'
launch counters would stand still: each capture's counts are recorded
(:mod:`repro_torch.kernels.counters`) and added on each of its replays.

A graph belongs to the state it was captured over, so each session owns
its ``StepPrograms`` (the reference shares its programs process-wide).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import counters
from repro_torch.serving import mtp as MTP
from repro_torch.serving import tbo as TBO
from repro_torch.serving.sampling import greedy, sample_batch, sample_one
from repro_torch.serving.state import EngineState, RoundOut, promote_slot


def chunk_bucket(ck: int, prefill_chunk: int) -> int:
    """Shape bucket of a (possibly ragged) prefill chunk: the smallest
    power of two >= ``ck``, capped at ``prefill_chunk``."""
    b = 1
    while b < ck:
        b <<= 1
    return min(b, prefill_chunk)


def _select(state: EngineState, logits: torch.Tensor, g: torch.Tensor,
            sampled: bool) -> torch.Tensor:
    """Each slot's token from ``logits [B,V]``: the greedy ``g``, or, in the
    sampling variant, a draw keyed by ``(seed, emit_index)`` for the slots
    that sample (the reference's ``_maybe_sample``)."""
    if not sampled:
        return g
    smp = sample_batch(state.seed, state.emit_index, logits,
                       state.temperature, state.top_k, state.top_p)
    return torch.where(state.sample_mask, smp, g)


def _make_raw_step(tbo: bool, streams: TBO.Streams) -> Callable:
    """``(params, cfg, tokens [B,Q], positions [B,Q], caches, slot_mask,
    staged) -> DecodeOut``: the model step both round kinds share,
    TBO-composed when ``tbo`` and the batch has two slots or more.  With a
    slab ``staged``, the whole batch's step leaves the slab's landing to
    the caller (``stats["land_slab"]``); TBO halves land their own."""
    from repro_torch.serving import engine as E   # engine imports this

    def raw(params, cfg, tokens, positions, caches, slot_mask=None,
            staged=None):
        if tbo and tokens.shape[0] >= 2:
            logits, merged, stats = TBO.tbo_step(
                E.ess_decode, params, cfg, tokens, positions, caches,
                slot_mask=slot_mask, streams=streams, staged=staged)
            return E.DecodeOut(logits, merged, stats)
        return E.ess_decode(params, cfg, tokens, positions, caches,
                            slot_mask=slot_mask,
                            fetch_stream=streams.fetch_a, staged=staged,
                            land_slab=False)

    return raw


def _land(stats: dict) -> None:
    """Join a pipelined step's slab gather and copy its rows into place
    (nothing to do for a synchronous step or TBO halves, which landed)."""
    land = stats.pop("land_slab", None)
    if land is not None:
        land()


def _pack_prefetch(out: RoundOut, stats: dict) -> None:
    if out.pf_hits is not None:
        out.pf_hits.copy_(stats["pf_hits"])
        out.pf_misses.copy_(stats["pf_misses"])
        out.pf_wasted.copy_(stats["pf_wasted"])


def _decode_round_fn(cfg: ArchConfig, raw: Callable, sampled: bool
                     ) -> Callable:
    """Plain Q = 1 round over the whole slot batch, in place."""
    def fn(params: dict, state: EngineState, out: RoundOut) -> None:
        caches = state.caches
        live = state.slot_mask
        o = raw(params, cfg, state.tok[:, None], caches.lens[:, None],
                caches, slot_mask=live, staged=state.staged)
        logits = o.logits[:, -1]                                  # [B,V]
        t = _select(state, logits, greedy(logits), sampled)
        _land(o.stats)
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
        _pack_prefetch(out, o.stats)

    return fn


def _spec_round_fn(cfg: ArchConfig, raw: Callable, depth: int,
                   sampled: bool) -> Callable:
    """The MTP round: draft, Q = depth + 1 verify (through ``raw``),
    accept and roll back, then emission packing (``n_emit`` 1 for
    sampling slots, the accepted count for greedy ones, 0 for frozen
    ones), in place."""
    def fn(params: dict, state: EngineState, out: RoundOut) -> None:
        live = state.slot_mask

        def verify(p_, c_, t_, po_, ca_):
            return raw(p_, c_, t_, po_, ca_, slot_mask=live,
                       staged=state.staged)
        spec = MTP.speculative_step(
            params, cfg, state.caches, state.tok, state.hidden,
            slot_mask=live, sample_mask=state.sample_mask, depth=depth,
            decode_fn=verify, staged_ids=state.staged_ids)
        t0 = _select(state, spec.logits[:, 0], spec.tokens[:, 0], sampled)
        _land(spec.stats)
        tokens = torch.cat([t0[:, None], spec.tokens[:, 1:]], dim=1)
        n_emit = torch.where(live, torch.where(state.sample_mask, 1,
                                               spec.n_accepted), 0)
        last = tokens.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
        state.tok.copy_(torch.where(live, last, state.tok))
        state.hidden.copy_(torch.where(live[:, None], spec.hidden,
                                       state.hidden))
        state.emit_index.add_(live.int())
        out.tokens.copy_(torch.where(live[:, None], tokens, 0))
        out.n_emit.copy_(n_emit)
        out.h2d_rows.copy_(spec.stats["misses"].sum().view(1))
        out.hit_rows.copy_(spec.stats["hits"].sum().view(1))
        _pack_prefetch(out, spec.stats)

    return fn


def _prefill_round_fn(cfg: ArchConfig, last: bool, sampled: bool
                      ) -> Callable:
    """One bucketed prefill chunk for host-int ``slot``; on the last chunk
    the first token is selected on the device (greedy, or drawn at
    emission index 0 in the sampling variant) and the slot promoted.
    Returns that token (a ``[1]`` device tensor) or None."""
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
        lg_last = lg[0, max(n_valid - 1, 0)]                      # [V]
        t0 = greedy(lg_last).view(1)
        if sampled:
            s = slice(slot, slot + 1)
            t0 = sample_one(state.seed[s], state.emit_index[s], lg_last,
                            state.temperature[s], state.top_k[s],
                            state.top_p[s])
        promote_slot(state, slot, t0[0], hid_last[0])
        return t0

    return fn


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    bound: tuple              # ids of (params, state, out) it reads
    delta: dict               # launch counts one replay stands for


class StepPrograms:
    """The round functions of one session.  ``decode`` / ``spec`` take
    ``(compiled, sampled)`` and return the graph-replaying round or the
    eager one; every round takes ``(params, state, out)`` and updates them
    in place.  ``depth`` is the session's MTP draft depth (0: no spec
    round); ``tbo`` composes Two-Batch Overlap into both round kinds.
    The side streams (:class:`repro_torch.serving.tbo.Streams`) are made
    here, for ``device`` (the card by default), before any capture."""

    def __init__(self, cfg: ArchConfig, depth: int = 0, *,
                 tbo: bool = False, device=None):
        self._cfg = cfg
        self.depth = depth
        self.tbo = tbo
        self.streams = TBO.make_streams(resolve_device(device))
        self._raw = _make_raw_step(tbo, self.streams)
        self._rounds: dict[tuple[bool, bool], Callable] = {}
        self._prefill: dict[tuple[int, bool, bool], Callable] = {}
        self._graphs: dict[tuple[bool, bool], _Captured] = {}
        self._pool = None
        self.replays = 0

    @property
    def captures(self) -> int:
        """Round variants captured so far (each ran one eager round)."""
        return len(self._graphs)

    def _round(self, spec: bool, sampled: bool) -> Callable:
        key = (spec, sampled)
        fn = self._rounds.get(key)
        if fn is None:
            fn = self._rounds[key] = (
                _spec_round_fn(self._cfg, self._raw, self.depth, sampled)
                if spec else _decode_round_fn(self._cfg, self._raw, sampled))
        return fn

    def decode(self, compiled: bool, sampled: bool = False) -> Callable:
        return self._program(False, sampled, compiled)

    def spec(self, compiled: bool, sampled: bool = False) -> Callable:
        return self._program(True, sampled, compiled)

    def _program(self, spec: bool, sampled: bool, compiled: bool
                 ) -> Callable:
        fn = self._round(spec, sampled)
        if not compiled:
            return fn

        def replay(params: dict, state: EngineState, out: RoundOut) -> None:
            self._replay((spec, sampled), fn, params, state, out)
        return replay

    def prefill(self, C: int, last: bool, sampled: bool = False
                ) -> Callable:
        fn = self._prefill.get((C, last, sampled))
        if fn is None:
            fn = self._prefill[(C, last, sampled)] = _prefill_round_fn(
                self._cfg, last, sampled)
        return fn

    def _replay(self, key: tuple, fn: Callable, params: dict,
                state: EngineState, out: RoundOut) -> None:
        cap = self._graphs.get(key)
        if cap is None:
            if not state.caches.lens.is_cuda:
                raise ValueError("compiled=True replays a CUDA graph and "
                                 "needs the session on a CUDA device; "
                                 "pass compiled=False on the CPU")
            fn(params, state, out)                   # warm-up: a real round
            self._graphs[key] = self._capture(fn, params, state, out)
            return
        if cap.bound != (id(params), id(state), id(out)):
            raise ValueError("a round graph replays the buffers it was "
                             "captured over; a new state needs new "
                             "StepPrograms")
        cap.graph.replay()
        counters.add(cap.delta)
        self.replays += 1

    def _capture(self, fn: Callable, params: dict, state: EngineState,
                 out: RoundOut) -> _Captured:
        """Capture one round on a side stream, into the graph memory pool
        the variants share.  Nothing runs: the round's work is recorded, to
        replay from the next round of this variant on.  The launches the
        wrappers counted while recording are taken back and kept as the
        per-replay delta.  Relaxed capture mode: the wrappers query their
        pinned tier's attributes on the host, which the global mode
        refuses; a sync inside the round still fails the capture.  The
        round's side streams (made before) join the capture at their
        forks and are joined back before it ends."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="relaxed")
            try:
                fn(params, state, out)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        delta = counters.diff(counters.snapshot(), before)
        counters.restore(before)
        return _Captured(graph, (id(params), id(state), id(out)), delta)
