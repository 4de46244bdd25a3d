"""Prefill and decode workers of a PD-disaggregated serving cluster
(counterpart of ``repro.cluster.workers``).

Each worker wraps one :class:`repro_torch.serving.engine.ServeSession`,
the round core the single engine drives, and runs its half of a
request's life:

* :class:`PrefillWorker` admits requests and streams their prompts
  through chunked prefill into its own paged host tier.  When a slot
  promotes, the worker packs it into a
  :class:`~repro_torch.cluster.kv_transfer.MigrationPacket` (one host
  wait) and releases it with ``Scheduler.release_migrated``, so the slot
  takes the next prompt at once.
* :class:`DecodeWorker` installs arriving packets (block-table remap +
  raw page write, no host sync) and runs the ordinary decode / verify
  rounds.  A preemption there requeues and re-prefills locally.

Several workers on one card share one set of weights (``params`` is
passed, not copied); each has its own pinned tier, pools, streams and
graphs.  Both take ``session_cls`` so that an instrumented session can
be injected.
"""

from __future__ import annotations

from repro_torch.cluster import kv_transfer as KT
from repro_torch.serving import engine as E
from repro_torch.serving.scheduler import Request, WorkerLoad


class PrefillSessionMixin:
    """Session overrides for the prefill side of a PD split.

    * ``do_warmup`` sessions do not replay the LRU warmup here (the Sparse
      Memory Pool lives with decode): the tails are stashed and shipped in
      the packet;
    * the warmup path's host-resolved first token goes into
      ``_pending_first`` (as the bucketed path's device scalar does), so
      pack and install own its delivery.  The prefill worker never runs a
      decode round, so no ``_plan_round`` resolves it."""

    def _warmup_slot(self, slot, tails, prompt_len):
        if not hasattr(self, "migration_tails"):
            self.migration_tails = {}
        self.migration_tails[slot] = tails

    def _finish_prefill(self, slot, task, t0):
        req = task.req
        self.sched.promote(slot)
        # a host dict, not a tensor: no copy, no wait
        self._rounds_since_promote[slot] = 0  # esslint: disable=ESS002
        del self._prefill[slot]
        self._pending_first.append((slot, req, t0))


def make_prefill_session(base=E.ServeSession):
    """Subclass ``base`` with the prefill-side overrides (idempotent)."""
    if issubclass(base, PrefillSessionMixin):
        return base
    return type("PrefillSession", (PrefillSessionMixin, base), {})


class PrefillWorker:
    """One prefill node: admits prompts, emits migration packets."""

    def __init__(self, params, cfg, *, num_slots: int, max_seq: int,
                 session_cls=None, **session_kw):
        cls = make_prefill_session(session_cls or E.ServeSession)
        self.session = cls(params, cfg, num_slots=num_slots,
                           max_seq=max_seq, **session_kw)
        self.migrations = 0

    def submit(self, req: Request) -> list:
        """Enqueue a request; returns the events drained at once (an
        unservable request's rejection surfaces here)."""
        self.session.submit(req)
        return self.session.drain_events()

    def abort(self, rid: int, *, reason: str = "abort") -> bool:
        return self.session.abort(rid, reason=reason)

    def owns(self, rid: int) -> bool:
        s = self.session
        return rid in s.sched.running \
            or any(r.rid == rid for r in s.sched.queue)

    def step(self) -> tuple[list, list]:
        """One prefill round: admissions + one prompt chunk; promoted slots
        pack into migration packets and release at once.  Returns
        ``(events, packets)``."""
        s = self.session
        s.admit()
        s.prefill_round()
        packets = []
        pending, s._pending_first = s._pending_first, []
        for slot, req, t0 in pending:
            st = s.sched.slots[slot]
            if not (st.active and st.rid == req.rid):
                continue       # aborted between promotion and pack
            tails = getattr(s, "migration_tails", {}).pop(slot, None)
            pkt = KT.pack_migration(
                s, slot, req, t0, tails=tails,
                submit_time=s._submit_time.get(req.rid))
            s.sched.release_migrated(slot)
            s.report.events.append(
                f"round {s._round}: rid={req.rid} migrated out "
                f"({pkt.n_pages} pages, {pkt.wire_bytes} B)")
            packets.append(pkt)
            self.migrations += 1
        s._round += 1
        return s.drain_events(), packets


class DecodeWorker:
    """One decode node: installs migrated prompts, runs decode rounds."""

    def __init__(self, params, cfg, *, num_slots: int, max_seq: int,
                 session_cls=None, **session_kw):
        cls = session_cls or E.ServeSession
        self.session = cls(params, cfg, num_slots=num_slots,
                           max_seq=max_seq, **session_kw)
        self.installed = 0

    def can_accept(self, req: Request) -> bool:
        return KT.can_accept(self.session, req)

    def bytes_needed(self, req: Request) -> int:
        """Host bytes the request pins here (the tier dtype's page bytes)."""
        return self.session.pages_needed(req) * self.session.host_page_bytes

    def load(self, index: int) -> WorkerLoad:
        """Admission headroom in bytes, for the router's placement."""
        s = self.session
        free_pages = (1 << 30) if s.allocator is None \
            else s.allocator.free_pages
        return WorkerLoad(
            worker=index,
            free_host_bytes=free_pages * max(1, s.host_page_bytes),
            free_slots=sum(not sl.active for sl in s.sched.slots),
            queued=len(s.sched.running) + len(s.sched.queue))

    def install(self, packet: KT.MigrationPacket) -> int:
        self.installed += 1
        return KT.install_migration(self.session, packet)

    def owns(self, rid: int) -> bool:
        s = self.session
        return rid in s.sched.running \
            or any(r.rid == rid for r in s.sched.queue)

    def abort(self, rid: int, *, reason: str = "abort") -> bool:
        return self.session.abort(rid, reason=reason)

    def step(self) -> list:
        """One serve round (admit -> local re-prefill chunk -> decode)."""
        return self.session.step_round()
