"""EssCluster, the PD-disaggregated drop-in for :class:`EssEngine`
(counterpart of ``repro.cluster.cluster``).

One facade over ``num_prefill`` prefill workers, ``num_decode`` decode
workers, a :class:`Router` and an :class:`InterNodeChannel`, with the
single engine's surface: ``submit`` / ``step`` / ``stream`` / ``generate``
/ ``abort`` / ``output`` / ``metrics``.  On one card the workers share the
weights.

One cluster step:

1. every prefill worker runs one round (admissions + one prompt chunk);
   freshly promoted slots pack into migration packets (one host wait
   each) and enter the channel;
2. the channel ticks; arrived packets are placed by the router (most free
   host bytes; full workers routed around, unplaceable packets held for
   the next step) and installed (block-table remap, raw page write, first
   token delivered);
3. every decode worker runs one round.

Streams equal a single engine's serving the same prompts, bit for bit,
where the decode round's per-slot math does not depend on the slot's
co-residents (a miss envelope and a MoE capacity that cannot bind).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterator, Optional, Sequence, Union

from repro_torch.cluster import kv_transfer as KT
from repro_torch.cluster.router import Router
from repro_torch.cluster.workers import DecodeWorker, PrefillWorker
from repro_torch.serving.api import (RequestOutput, SamplingParams,
                                     TokenEvent, batch_params, drive,
                                     latency_stats, prompt_tensor)
from repro_torch.serving.scheduler import Request


class EssCluster:
    """Prefill/decode-disaggregated serving cluster facade."""

    def __init__(self, params, cfg, *, num_prefill: int = 1,
                 num_decode: int = 1, num_slots: int = 2, max_seq: int,
                 prefill_slots: Optional[int] = None,
                 decode_slots: Optional[int] = None,
                 channel: Optional[KT.InterNodeChannel] = None,
                 prefill_session_cls=None, decode_session_cls=None,
                 decode_overrides: Optional[Sequence[Optional[dict]]] = None,
                 **session_kw):
        self._user_prompt_fn = session_kw.pop("prompt_fn", None)
        kw = dict(session_kw, prompt_fn=self._prompt_for)
        self.prefill = [
            PrefillWorker(params, cfg,
                          num_slots=prefill_slots or num_slots,
                          max_seq=max_seq, session_cls=prefill_session_cls,
                          **kw)
            for _ in range(num_prefill)]
        self.decode = []
        for i in range(num_decode):
            wkw = dict(kw)
            if decode_overrides and decode_overrides[i]:
                wkw.update(decode_overrides[i])
            self.decode.append(
                DecodeWorker(params, cfg,
                             num_slots=decode_slots or num_slots,
                             max_seq=max_seq,
                             session_cls=decode_session_cls, **wkw))
        self.router = Router(self.prefill, self.decode)
        self.channel = channel or KT.InterNodeChannel()
        self._next_rid = 0
        self._prompts: dict[int, Any] = {}
        self._plens: dict[int, int] = {}
        self._buffers: dict[int, deque] = {}
        self._outputs: dict[int, list] = {}
        self._terminal: dict[int, str] = {}
        self._ttft_s: dict[int, float] = {}
        self._submit_time: dict[int, float] = {}
        self._event_log: list[TokenEvent] = []
        self._pending_place: list[KT.MigrationPacket] = []
        self._aborted_in_transit = 0
        self._steps = 0

    # -- request lifecycle ---------------------------------------------------

    def _prompt_for(self, req: Request):
        p = self._prompts.get(req.rid)
        if p is not None:
            return p
        if self._user_prompt_fn is not None:
            return self._user_prompt_fn(req)
        # the same synthetic prompt on every worker (and in a single
        # engine serving the same rid)
        return self.prefill[0].session._default_prompt(req)

    def submit(self, prompt: Union[int, Sequence[int]],
               params: Optional[SamplingParams] = None) -> int:
        """Enqueue one request on a prefill worker (round-robin); returns
        its rid, as :meth:`EssEngine.submit`."""
        params = params or SamplingParams()
        rid = self._next_rid
        self._next_rid += 1
        if isinstance(prompt, int):
            plen = prompt
        else:
            toks = prompt_tensor(prompt, self.prefill[0].session.device)
            self._prompts[rid] = toks
            plen = int(toks.shape[1])
        self._plens[rid] = plen
        self._buffers.setdefault(rid, deque())
        self._submit_time[rid] = time.perf_counter()
        req = params.request(rid, plen)
        w = self.router.route_prefill(req)
        self._distribute(self.prefill[w].submit(req))
        return rid

    def abort(self, rid: int, *, reason: str = "abort") -> bool:
        """Abort wherever the request lives: a prefill queue or slot, the
        channel (mid-handoff: the packet is dropped; the prefill side freed
        its pages at pack, the decode side never saw it), or a decode
        worker."""
        if rid in self._terminal:
            return False
        for w in self.prefill:
            if w.owns(rid):
                ok = w.abort(rid, reason=reason)
                self._distribute(w.session.drain_events())
                return ok
        dropped = self.channel.cancel(rid)
        held = [p for p in self._pending_place if p.rid == rid]
        if dropped or held:
            self._pending_place = [p for p in self._pending_place
                                   if p.rid != rid]
            req = (dropped or held)[0].req
            req.finished = True
            req.finish_reason = reason
            self._aborted_in_transit += 1
            self._distribute([TokenEvent(
                rid=rid, token=None, index=0, finish_reason=reason,
                t=time.perf_counter())])
            return True
        for w in self.decode:
            if w.owns(rid):
                ok = w.abort(rid, reason=reason)
                self._distribute(w.session.drain_events())
                return ok
        return False

    def step(self) -> list:
        """One cluster step: prefill rounds -> channel tick + placement ->
        decode rounds.  Returns (and buffers) the step's TokenEvents."""
        evs: list[TokenEvent] = []
        for w in self.prefill:
            wevs, packets = w.step()
            evs += wevs
            for pkt in packets:
                self.channel.send(pkt)
        pending = self._pending_place + self.channel.tick()
        self._pending_place = []
        for pkt in pending:
            tgt = self.router.place(pkt.req)
            if tgt is None:
                self._pending_place.append(pkt)   # route around: retry
                continue
            self.decode[tgt].install(pkt)
        for w in self.decode:
            evs += w.step()
        self._distribute(evs)
        self._steps += 1
        return evs

    def _distribute(self, evs) -> None:
        for ev in evs:
            self._event_log.append(ev)
            self._buffers.setdefault(ev.rid, deque()).append(ev)
            if ev.is_terminal:
                self._terminal[ev.rid] = ev.finish_reason
            elif ev.token is not None:
                out = self._outputs.setdefault(ev.rid, [])
                # a preempted request's re-admission regenerates its
                # stream from index 0: truncate and replay
                del out[ev.index:]
                out.append(ev.token)
                if ev.index == 0 and ev.rid in self._submit_time:
                    self._ttft_s.setdefault(
                        ev.rid, ev.t - self._submit_time[ev.rid])

    # -- results -------------------------------------------------------------

    def is_finished(self, rid: int) -> bool:
        return rid in self._terminal

    def finish_reason(self, rid: int) -> Optional[str]:
        return self._terminal.get(rid)

    def has_work(self) -> bool:
        if self.channel.in_flight or self._pending_place:
            return True
        return any(w.session.sched.running or w.session.sched.queue
                   for w in self.prefill + self.decode)

    def stream(self, rid: int) -> Iterator[TokenEvent]:
        """Incremental results for one rid, driving cluster steps as
        needed; single-consumer per rid (as :meth:`EssEngine.stream`)."""
        buf = self._buffers[rid]
        while True:
            while buf:
                ev = buf.popleft()
                yield ev
                if ev.is_terminal:
                    return
            if self.is_finished(rid):
                return
            if not self.has_work():
                raise RuntimeError(
                    f"rid={rid} stream stalled: cluster idle with no "
                    f"terminal event")
            self.step()

    def output(self, rid: int) -> RequestOutput:
        assert rid in self._terminal, f"rid={rid} has not finished"
        return RequestOutput(
            rid=rid, prompt_len=self._plens.get(rid, 0),
            tokens=list(self._outputs.get(rid, [])),
            finish_reason=self._terminal[rid],
            ttft_s=self._ttft_s.get(rid))

    def generate(self, prompts: Sequence,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None, *,
                 max_rounds: int = 200) -> list:
        """Batch convenience, as :meth:`EssEngine.generate`."""
        params = batch_params(prompts, params)
        rids = [self.submit(p, sp) for p, sp in zip(prompts, params)]
        drive(self.step, self.is_finished,
              lambda r: self.abort(r, reason="budget"), rids, max_rounds)
        return [self.output(r) for r in rids]

    def metrics(self) -> dict:
        """Cluster-wide counters: the workers' reports summed, handoff and
        channel accounting, latency percentiles over the global event
        log."""
        reps = [w.session.report for w in self.prefill + self.decode]
        dreps = [w.session.report for w in self.decode]
        m = {
            "cluster_steps": self._steps,
            "num_prefill_workers": len(self.prefill),
            "num_decode_workers": len(self.decode),
            "rounds": sum(r.rounds for r in dreps),
            "spec_rounds": sum(r.spec_rounds for r in dreps),
            "decode_tokens": sum(r.decode_tokens for r in dreps),
            "prefill_tokens": sum(r.prefill_tokens for r in reps),
            "prefill_chunks": sum(r.prefill_chunks for r in reps),
            "migrations": sum(w.migrations for w in self.prefill),
            "installed": sum(w.installed for w in self.decode),
            "packets_in_flight": len(self.channel.in_flight),
            "packets_held": len(self._pending_place),
            "wire_bytes": self.channel.payload_bytes,
            "sim_transfer_s": self.channel.sim_transfer_s,
            "rejected": sum(r.rejected for r in reps),
            "aborted": (sum(r.aborted for r in reps)
                        + self._aborted_in_transit),
            "h2d_rows": sum(r.h2d_rows for r in dreps),
            "d2h_rows": sum(r.d2h_rows for r in reps),
            "finish_reasons": dict(self._terminal),
        }
        m.update(latency_stats(self._event_log, self._submit_time))
        return m
