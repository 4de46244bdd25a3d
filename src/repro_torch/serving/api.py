"""Public serving API over the continuous-batching session (counterpart of
``repro.serving.api``).

* :class:`SamplingParams` — per-request generation knobs (temperature /
  top-k / top-p / seed, ``max_tokens``, EOS and stop token sets, admission
  ``priority``);
* :class:`TokenEvent` — one element of a request's stream: a delivered
  token, or the request's single terminal record (``finish_reason`` set);
* :class:`RequestOutput` — the aggregate result of one finished request;
* :func:`latency_stats` — p50 / p95 TTFT and inter-token gap from the
  events' stamps;
* :class:`EssEngine` — the facade: ``submit(prompt, params) -> rid``,
  ``step() -> [TokenEvent]``, ``stream(rid)``, ``generate(prompts,
  params)``, ``abort(rid)``, ``output(rid)`` and ``metrics()``, driving
  :meth:`repro_torch.serving.engine.ServeSession.step_round`.  Requests
  can be submitted and aborted between any two rounds.

Every rid ends with exactly one terminal event, ``finish_reason`` one of
``stop`` (EOS or stop token), ``length`` (budget or ``max_seq``),
``abort``, ``rejected`` (oversize) or ``budget`` (``generate``'s round
budget spent).  A preemption is not terminal: the request requeues and
its re-admission regenerates the same stream.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import upload
from repro_torch.serving.scheduler import Request

FINISH_REASONS = ("stop", "length", "abort", "rejected", "budget")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs.

    ``temperature == 0`` is greedy; ``top_k=None`` / ``top_p=None`` turn
    the truncation off; ``seed=None`` keys the sampler on the rid.  A
    token in ``eos_token_ids | stop_token_ids`` ends the stream at its
    position (``finish_reason="stop"``; a speculative round's
    over-accepted suffix is rolled back).  ``priority`` orders admission
    (higher first, FIFO within a class)."""
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    eos_token_ids: tuple = ()
    stop_token_ids: tuple = ()
    priority: int = 0

    def request(self, rid: int, prompt_len: int) -> Request:
        """The scheduler's request for these knobs."""
        return Request(
            rid=rid, prompt_len=prompt_len, max_new_tokens=self.max_tokens,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, seed=self.seed,
            eos_token_ids=tuple(self.eos_token_ids),
            stop_token_ids=tuple(self.stop_token_ids),
            priority=self.priority)


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One element of a request's incremental result stream.

    Token events carry ``token`` with ``finish_reason=None``; the single
    terminal event carries ``finish_reason`` with ``token=None`` and
    ``index`` = the final stream length.  ``t`` is a
    ``time.perf_counter`` stamp at delivery."""
    rid: int
    token: Optional[int]
    index: int
    finish_reason: Optional[str] = None
    t: float = 0.0

    @property
    def is_terminal(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class RequestOutput:
    """Aggregate result of one finished request."""
    rid: int
    prompt_len: int
    tokens: list
    finish_reason: str
    ttft_s: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.tokens)


def _pctl(vals: list, q: float) -> Optional[float]:
    if not vals:
        return None
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(round(q * (len(vs) - 1))))]


def latency_stats(events: Sequence[TokenEvent],
                  submit_times: dict) -> dict:
    """p50 / p95 TTFT and inter-token gap from TokenEvent stamps.

    TTFT is a rid's first token event's stamp minus its submit stamp; the
    inter-token gap is the difference of consecutive token events' stamps
    per rid (the tokens of one speculative round share a stamp)."""
    ttft, gaps = [], []
    prev: dict[int, float] = {}
    for ev in events:
        if ev.token is None:
            continue
        if ev.index == 0:
            sub = submit_times.get(ev.rid)
            if sub is not None:
                ttft.append(ev.t - sub)
        elif ev.rid in prev:
            gaps.append(ev.t - prev[ev.rid])
        prev[ev.rid] = ev.t
    return {
        "ttft_p50_s": _pctl(ttft, 0.50),
        "ttft_p95_s": _pctl(ttft, 0.95),
        "itl_p50_s": _pctl(gaps, 0.50),
        "itl_p95_s": _pctl(gaps, 0.95),
        "n_token_events": len(ttft) + len(gaps),
    }


def prompt_tensor(prompt: Sequence[int], device) -> torch.Tensor:
    """An explicit prompt as int32 ``[1, n]`` on ``device`` (copied from
    pinned memory without waiting for the card)."""
    t = torch.as_tensor(np.asarray(prompt, dtype=np.int32)).reshape(1, -1)
    return upload(t, device)


def drive(step, is_finished, abort, rids: list, max_rounds: int) -> None:
    """``generate``'s loop, shared by the engine and the cluster: step until
    every rid is finished; after ``max_rounds`` steps the rest end with
    ``finish_reason="budget"``."""
    budget = max_rounds
    while any(not is_finished(r) for r in rids):
        step()
        budget -= 1
        if budget <= 0:
            for r in rids:
                if not is_finished(r):
                    abort(r)
            break


def batch_params(prompts: Sequence, params) -> list:
    if params is None or isinstance(params, SamplingParams):
        params = [params or SamplingParams()] * len(prompts)
    assert len(params) == len(prompts)
    return list(params)


class EssEngine:
    """Request-lifecycle facade over one
    :class:`~repro_torch.serving.engine.ServeSession`.

    Takes the session's knobs (``num_slots``, ``max_seq``,
    ``num_host_pages``, ``prefill_chunk``, ``mtp_depth``, ``tbo``,
    ``compiled``, ``overlap``, ``device``, ...).  A prompt is an ``int``
    (a synthetic prompt of that length from the session's
    ``prompt_fn``, or its default prompt) or an explicit token sequence.

    The engine assigns rids, buffers each round's events per rid and
    guarantees each stream ends with exactly one terminal event.
    ``stream(rid)`` is single-consumer per rid; any call to :meth:`step`
    advances every request in flight by one serve round."""

    def __init__(self, params, cfg, *, num_slots: int, max_seq: int,
                 **session_kw):
        from repro_torch.serving import engine as E   # engine imports api
        self._user_prompt_fn = session_kw.pop("prompt_fn", None)
        self.session = E.ServeSession(params, cfg, num_slots=num_slots,
                                      max_seq=max_seq,
                                      prompt_fn=self._prompt_for,
                                      **session_kw)
        self._next_rid = 0
        self._prompts: dict[int, Any] = {}
        self._plens: dict[int, int] = {}
        self._buffers: dict[int, deque] = {}

    # -- request lifecycle ---------------------------------------------------

    def _prompt_for(self, req: Request):
        p = self._prompts.get(req.rid)
        if p is not None:
            return p
        if self._user_prompt_fn is not None:
            return self._user_prompt_fn(req)
        return self.session._default_prompt(req)

    def submit(self, prompt: Union[int, Sequence[int]],
               params: Optional[SamplingParams] = None) -> int:
        """Enqueue one request; returns its rid.  Admission happens at the
        next :meth:`step`.  A request that needs more host pages than the
        pool holds is rejected at once: its terminal event is buffered
        when ``submit`` returns."""
        params = params or SamplingParams()
        rid = self._next_rid
        self._next_rid += 1
        if isinstance(prompt, int):
            plen = prompt
        else:
            toks = prompt_tensor(prompt, self.session.device)
            self._prompts[rid] = toks
            plen = int(toks.shape[1])
        self._plens[rid] = plen
        self._buffers.setdefault(rid, deque())
        self.session.submit(params.request(rid, plen))
        self._distribute(self.session.drain_events())
        return rid

    def abort(self, rid: int, *, reason: str = "abort") -> bool:
        """Abort a queued or running request between rounds: its host pages
        return at once, the slot resets and the stream closes with
        ``finish_reason=reason``."""
        ok = self.session.abort(rid, reason=reason)
        self._distribute(self.session.drain_events())
        return ok

    def step(self) -> list:
        """Run one serve round; returns (and buffers) its TokenEvents."""
        evs = self.session.step_round()
        self._distribute(evs)
        return evs

    def _distribute(self, evs) -> None:
        for ev in evs:
            self._buffers.setdefault(ev.rid, deque()).append(ev)

    # -- results -------------------------------------------------------------

    def is_finished(self, rid: int) -> bool:
        return rid in self.session._terminal

    def finish_reason(self, rid: int) -> Optional[str]:
        return self.session._terminal.get(rid)

    def has_work(self) -> bool:
        return bool(self.session.sched.running or self.session.sched.queue)

    def stream(self, rid: int) -> Iterator[TokenEvent]:
        """Incremental results for one rid, driving serve rounds as needed;
        ends after yielding the terminal event."""
        buf = self._buffers[rid]
        while True:
            while buf:
                ev = buf.popleft()
                yield ev
                if ev.is_terminal:
                    return
            if self.is_finished(rid):
                return                     # terminal already consumed
            if not self.has_work():
                raise RuntimeError(
                    f"rid={rid} stream stalled: engine idle with no "
                    f"terminal event")
            self.step()

    def output(self, rid: int) -> RequestOutput:
        """Aggregate result; the rid must have finished."""
        ses = self.session
        assert rid in ses._terminal, f"rid={rid} has not finished"
        return RequestOutput(
            rid=rid, prompt_len=self._plens.get(rid, 0),
            tokens=list(ses.outputs.get(rid, [])),
            finish_reason=ses._terminal[rid],
            ttft_s=ses.report.ttft_s.get(rid))

    def generate(self, prompts: Sequence,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None, *,
                 max_rounds: int = 200) -> list:
        """Submit a batch and drive the loop until every request has its
        terminal event; returns RequestOutputs in submission order.
        Requests unfinished after ``max_rounds`` rounds end with
        ``finish_reason="budget"``."""
        params = batch_params(prompts, params)
        rids = [self.submit(p, sp) for p, sp in zip(prompts, params)]
        drive(self.step, self.is_finished,
              lambda r: self.abort(r, reason="budget"), rids, max_rounds)
        return [self.output(r) for r in rids]

    def metrics(self) -> dict:
        """Serving counters and latency percentiles (from TokenEvent stamps)
        for everything this engine has served so far."""
        rep = self.session.report
        m = {
            "rounds": rep.rounds,
            "spec_rounds": rep.spec_rounds,
            "decode_tokens": rep.decode_tokens,
            "prefill_tokens": rep.prefill_tokens,
            "prefill_chunks": rep.prefill_chunks,
            "accept_rate": rep.accept_rate,
            "rejected": rep.rejected,
            "aborted": rep.aborted,
            "finish_reasons": dict(rep.finish_reasons),
            "admissions_blocked": self.session.sched.blocked_admissions,
            "peak_pages_in_use": rep.peak_pages_in_use,
            "num_pages": rep.num_pages,
            "prefetch_hits": rep.prefetch_hits,
            "prefetch_misses": rep.prefetch_misses,
            "prefetch_wasted_rows": rep.prefetch_wasted_rows,
            "prefetch_hit_rate": rep.prefetch_hit_rate,
        }
        m.update(latency_stats(self.session.token_events,
                               self.session._submit_time))
        return m
