"""Request routing for the PD-disaggregated cluster (counterpart of
``repro.cluster.router``).  Both decisions are deterministic:

* prefill placement: round-robin over the prefill workers;
* decode placement: :func:`repro_torch.serving.scheduler.pick_decode_worker`
  over the workers' byte-denominated loads, the worker with the most free
  host bytes among those that can admit now.  A full worker is routed
  around, never rejected; when none fits, the migration is held and tried
  again after the next cluster step.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.serving import scheduler as SCH
from repro_torch.serving.scheduler import Request


class Router:
    def __init__(self, prefill_workers: list, decode_workers: list):
        self.prefill = prefill_workers
        self.decode = decode_workers
        self._rr = 0

    def route_prefill(self, req: Request) -> int:
        """Round-robin prefill placement; returns the worker index."""
        i = self._rr % len(self.prefill)
        self._rr += 1
        return i

    def place(self, req: Request) -> Optional[int]:
        """Decode placement for a migrated request, or ``None`` to hold.
        ``need_bytes`` is the largest need across workers (a mixed-dtype
        fleet never over-places); ``can_accept`` checks the rest (pool
        entries)."""
        loads = [w.load(i) for i, w in enumerate(self.decode)]
        need = max(w.bytes_needed(req) for w in self.decode)
        pick = SCH.pick_decode_worker(loads, need)
        if pick is not None and not self.decode[pick].can_accept(req):
            return None
        return pick
