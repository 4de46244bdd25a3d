"""Continuous-batching scheduler, host side (the port's own copy of
``repro.serving.scheduler``, which is numpy-only; the port imports nothing
of the reference package).

Manages a fixed pool of decode slots: admission from a request queue,
completion and eviction, preemption with requeue, client aborts, and the
batch-size and memory accounting of the paper's analysis.

Admission is priority-aware: the candidate is the queued request with the
highest ``priority``, FIFO (submission order) within a priority class.  A
preempted request re-enters ahead of its class.  Deterministic: every
decision derives from (step, priority, submission order), and the
admission gate blocks on the selected candidate with no head-of-line
bypass.

Every request ends with exactly one ``finish_reason``
(``stop | length | abort | rejected | budget``); the scheduler stamps
``length`` and ``rejected`` itself, the engine the rest before calling
:meth:`Scheduler.finish` / :meth:`Scheduler.abort`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional



@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrived_step: int = 0
    generated: int = 0
    slot: Optional[int] = None
    finished: bool = False
    preempted_count: int = 0
    # per-request sampling: temperature == 0.0 -> greedy (the default);
    # > 0 draws from the (temperature, top_k, top_p)-shaped distribution
    # with a PRNG keyed on (seed, emission index) — see
    # the reference's serving.sampling.request_key.  seed=None derives
    # from rid.
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    # lifecycle (the reference's public serving API): emitting any
    # token in eos_token_ids | stop_token_ids terminates the stream at
    # that position (finish_reason="stop"); priority orders admission
    # (higher first, FIFO within a class); seq is the scheduler-assigned
    # submission rank; finish_reason is stamped exactly once at the end.
    eos_token_ids: tuple = ()
    stop_token_ids: tuple = ()
    priority: int = 0
    seq: int = 0
    finish_reason: Optional[str] = None

    @property
    def sampling(self) -> bool:
        return self.temperature > 0.0

    @property
    def stop_set(self) -> frozenset:
        return frozenset(self.eos_token_ids) | frozenset(self.stop_token_ids)

    @property
    def sample_seed(self) -> int:
        return self.rid if self.seed is None else self.seed


@dataclasses.dataclass
class SlotState:
    rid: int = -1
    active: bool = False
    len: int = 0
    phase: str = "idle"      # idle | prefill | decode
    # the engine delivered the prefill's first token at promotion: it
    # consumes one unit of the request's max_new_tokens budget, so the
    # decode-round budget is max_new_tokens - 1 and at finish
    # len(outputs) == generated + 1 (first token + decode deliveries)
    first_emitted: bool = False


class Scheduler:
    """Slot-based continuous batching with preemption.

    Resource hooks wire the scheduler to the engine's cache tiers:

    * ``admission_gate(req) -> bool`` — called before a queued request takes
      a free slot; the engine gates on free host pages / free pool entries.
      A ``False`` verdict blocks the queue head (FIFO — no head-of-line
      bypass, so admission order stays deterministic).
    * ``release_hook(slot)`` — called whenever a slot stops serving its
      request (completion, preemption *or* abort); the engine returns the
      slot's host pages and performs the full per-slot cache reset
      (:func:`repro_torch.cache.latent_cache.reset_slot`).
    * ``reject_hook(req)`` — called when an oversize request
      (``prompt_len + max_new_tokens > max_seq``) is bounced at admission
      so the engine can surface a terminal ``finish_reason="rejected"``
      event instead of letting the request silently vanish.
    """

    def __init__(self, num_slots: int, max_seq: int,
                 admission_gate: Optional[Callable[["Request"], bool]] = None,
                 release_hook: Optional[Callable[[int], None]] = None,
                 reject_hook: Optional[Callable[["Request"], None]] = None):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: deque[Request] = deque()
        self.running: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.step = 0
        self.admission_gate = admission_gate
        self.release_hook = release_hook
        self.reject_hook = reject_hook
        self.blocked_admissions = 0
        self._seq = 0          # submission rank (FIFO within a class)
        self._seq_front = -1   # preempted requests jump their class's line

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.arrived_step = self.step
        req.seq = self._seq
        self._seq += 1
        self.queue.append(req)

    def _next_candidate(self) -> Optional[Request]:
        """Highest priority first; stable FIFO (submission seq) within a
        priority class — deterministic in (priority, submission order)."""
        if not self.queue:
            return None
        return min(self.queue, key=lambda r: (-r.priority, r.seq))

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue; returns [(slot, request)] needing
        prefill."""
        admitted = []
        for i, s in enumerate(self.slots):
            if s.active:
                continue
            # reject oversize candidates outright (they can never be
            # admitted) and surface them via the reject hook
            while True:
                req = self._next_candidate()
                if req is None or (req.prompt_len + req.max_new_tokens
                                   <= self.max_seq):
                    break
                self.queue.remove(req)
                req.finished = True
                req.finish_reason = "rejected"
                self.finished.append(req)
                if self.reject_hook is not None:
                    self.reject_hook(req)
            if req is None:
                break
            if self.admission_gate is not None \
                    and not self.admission_gate(req):
                self.blocked_admissions += 1
                break                        # resources exhausted: wait
            self.queue.remove(req)
            s.rid, s.active, s.len = req.rid, True, req.prompt_len
            s.phase = "prefill"
            req.slot = i
            self.running[req.rid] = req
            admitted.append((i, req))
        return admitted

    # -- stepping -----------------------------------------------------------

    def active_slots(self) -> list[int]:
        """Decode-eligible slots.  Slots still streaming prefill chunks are
        admitted (they hold pages + a pool reservation) but must not take
        decode steps until :meth:`promote`."""
        return [i for i, s in enumerate(self.slots)
                if s.active and s.phase == "decode"]

    def prefill_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s.active and s.phase == "prefill"]

    def promote(self, slot: int) -> None:
        """Prefill finished: the slot joins the decode batch.  Promotion
        is the moment the engine delivers the prefill's first token, so
        it charges one unit of the ``max_new_tokens`` budget
        (``first_emitted``); callers must check :meth:`remaining` — a
        ``max_new_tokens == 1`` request is already done."""
        s = self.slots[slot]
        if s.active and s.phase == "prefill":
            s.phase = "decode"
            s.first_emitted = True

    def budget_left(self, slot: int) -> int:
        """max_new_tokens budget still open for decode deliveries (the
        prefill first token consumes one unit once promoted)."""
        s = self.slots[slot]
        if not s.active:
            return 0
        req = self.running[s.rid]
        return max(0, req.max_new_tokens - req.generated
                   - (1 if s.first_emitted else 0))

    def remaining(self, slot: int) -> int:
        """Tokens slot ``slot``'s request may still emit before finishing
        (budget *and* max_seq headroom).  ``_emit`` clamps every round's
        delivery to this, so a request never over-runs ``max_new_tokens``
        just because a verify round accepted more drafts than it had
        budget left."""
        s = self.slots[slot]
        if not s.active:
            return 0
        return max(0, min(self.budget_left(slot), self.max_seq - s.len))

    def record_tokens(self, slot_tokens: dict[int, int]) -> list[Request]:
        """slot -> n tokens *delivered* this step; returns newly finished.

        ``n`` may vary per slot and per round (Q>1 speculative decode
        emits ``n_accepted + 1`` tokens a round); ``s.len`` advances by
        exactly ``n`` so the scheduler's length view tracks the engine's
        rolled-back cache ``lens``.  The charge equals what the engine
        actually appended to the output stream (see ``ServeSession._emit``),
        so at finish ``len(outputs) == generated + first_emitted``."""
        done = []
        for i, n in slot_tokens.items():
            s = self.slots[i]
            if not s.active:
                continue
            req = self.running[s.rid]
            req.generated += n
            s.len += n
            limit = req.max_new_tokens - (1 if s.first_emitted else 0)
            if req.generated >= limit or s.len >= self.max_seq:
                req.finished = True
                if req.finish_reason is None:   # engine may have set "stop"
                    req.finish_reason = "length"
                done.append(req)
                self._release(i)
        self.step += 1
        return done

    def finish(self, slot: int) -> Request:
        """Force-complete a running slot mid-budget (EOS / stop-token
        termination): the engine stamps ``finish_reason`` first, then the
        slot releases exactly as a natural completion."""
        s = self.slots[slot]
        assert s.active, f"finish() on inactive slot {slot}"
        req = self.running[s.rid]
        req.finished = True
        if req.finish_reason is None:
            req.finish_reason = "stop"
        self._release(slot)
        return req

    def abort(self, rid: int) -> bool:
        """Abort a queued or running request (client disconnect / budget
        kill).  A running slot releases through the engine's hook (pages
        return, caches reset); a queued request is simply removed.  No
        requeue — the request is terminally finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                req.finished = True
                if req.finish_reason is None:
                    req.finish_reason = "abort"
                self.finished.append(req)
                return True
        req = self.running.get(rid)
        if req is None:
            return False
        req.finished = True
        if req.finish_reason is None:
            req.finish_reason = "abort"
        self._release(req.slot)
        return True

    # -- PD-disaggregated handoff edges --------------------------------------

    def adopt(self, req: Request, slot: int) -> None:
        """Install an already-prefilled request directly into a free slot
        (the decode side of a PD handoff): the request enters in the
        ``decode`` phase with ``first_emitted`` charged — the prefill
        worker computed its first token and the installing engine
        delivers it — bypassing the admission queue.  The byte/slot gate
        runs on the *installing worker* before calling this (the router's
        placement decision); the scheduler only records the occupancy."""
        s = self.slots[slot]
        assert not s.active, f"adopt() into occupied slot {slot}"
        assert req.rid not in self.running, \
            f"adopt(): rid={req.rid} already running here"
        s.rid, s.active, s.len = req.rid, True, req.prompt_len
        s.phase = "decode"
        s.first_emitted = True
        req.slot = slot
        req.finished = False
        self.running[req.rid] = req

    def release_migrated(self, slot: int) -> Request:
        """Release a slot whose request migrated to another worker: the
        resources free exactly as a completion (pages return, caches
        reset via the release hook) but the request is *not* finished —
        no terminal record here; the decode worker that adopted it owns
        the rest of its lifecycle."""
        s = self.slots[slot]
        assert s.active, f"release_migrated() on inactive slot {slot}"
        req = self.running.pop(s.rid)
        req.slot = None
        s.rid, s.active, s.len, s.phase = -1, False, 0, "idle"
        s.first_emitted = False
        if self.release_hook is not None:
            self.release_hook(slot)
        return req

    def preempt(self, slot: int) -> None:
        """Evict a running sequence (node loss / rebalance); it re-queues and
        will re-prefill on next admission (PD-disaggregation semantics).

        Per-attempt progress resets: the next attempt re-prefills from
        scratch and generates the full ``max_new_tokens`` again.  Carrying
        ``generated`` across attempts made :meth:`record_tokens` finish the
        re-admitted request ``generated`` tokens early."""
        s = self.slots[slot]
        if not s.active:
            return
        req = self.running.pop(s.rid)
        req.preempted_count += 1
        req.slot = None
        req.generated = 0
        # jump the line within its priority class (the old appendleft
        # semantics under priority-aware candidate selection)
        req.seq = self._seq_front
        self._seq_front -= 1
        self.queue.appendleft(req)
        s.rid, s.active, s.len, s.phase = -1, False, 0, "idle"
        s.first_emitted = False
        if self.release_hook is not None:
            self.release_hook(slot)

    def _release(self, slot: int) -> None:
        s = self.slots[slot]
        req = self.running.pop(s.rid, None)
        if req is not None:
            self.finished.append(req)
        s.rid, s.active, s.len, s.phase = -1, False, 0, "idle"
        s.first_emitted = False
        if self.release_hook is not None:
            self.release_hook(slot)

    # -- accounting ----------------------------------------------------------

    def occupancy(self) -> float:
        return sum(s.active for s in self.slots) / max(1, self.num_slots)


@dataclasses.dataclass(frozen=True)
class WorkerLoad:
    """One decode worker's admission headroom, byte-denominated.

    ``free_host_bytes`` is the worker's free host-page count times its
    *storage-dtype* page bytes (dtype-aware accounting: a
    quantized tier's smaller pages mean the same page count is less
    byte headroom than a bf16 tier's), so placement compares workers on
    the resource actually being rationed even across mixed-dtype fleets.
    """
    worker: int              # index into the router's decode-worker list
    free_host_bytes: int
    free_slots: int
    queued: int              # running + queued requests (tiebreak load)


def pick_decode_worker(loads: list[WorkerLoad],
                       need_bytes: int) -> Optional[int]:
    """Router placement: the decode worker with the most free host bytes
    among those that can admit *now* (a free slot and ``need_bytes`` of
    page headroom).  A full or byte-exhausted worker is routed around —
    never a rejection; if no worker can admit now the caller holds the
    request and retries after the next round frees resources (returns
    ``None``).  Ties break toward the lighter (fewer requests), then
    lower-indexed worker, keeping placement deterministic."""
    fits = [l for l in loads
            if l.free_slots > 0 and l.free_host_bytes >= need_bytes]
    if not fits:
        return None
    best = max(fits, key=lambda l: (l.free_host_bytes, -l.queued,
                                    -l.worker))
    return best.worker


def feasible_batch_size(hbm_bytes: int, weight_bytes_per_dev: int,
                        cache_bytes_per_seq: int, activation_slack: float
                        = 0.9) -> int:
    """Paper §2.1: GPU memory caps the decode batch.  Returns max B with
    full cache on device (the 'batch 52' ceiling)."""
    free = hbm_bytes * activation_slack - weight_bytes_per_dev
    return max(0, int(free // max(1, cache_bytes_per_seq)))
