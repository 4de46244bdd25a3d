"""Page-granular latent handoff between PD-disaggregated workers
(counterpart of ``repro.cluster.kv_transfer``).

A prompt is prefilled on a prefill worker; its cache state then migrates
to a decode worker that owns the request from there on.  A migration
moves, **in the host tier's storage dtype** (an int8/fp8 payload and its
f16 scale plane travel verbatim, never dequantized):

* the slot's mapped host pages ``[L, n_used, R, D]`` and, on a quantized
  tier, their scales ``[L, n_used, R, 1]``;
* the indexer keys ``[plen, Di]`` per layer (device-resident, never
  offloaded);
* the first token and the post-final-norm hidden (the MTP draft seed);
* optionally the LRU-warmup tails, replayed on the decode side.

The packet is host-resident, in pinned buffers when the session is on the
card.  :func:`pack_migration` fills it with one page-gather launch over
every layer and both planes, written into the pinned packet through its
UVA pointer on the prefill session's stream, then copies of the keys, the
hidden and the first token, and makes **exactly one host wait**
(:func:`host_wait`, the reference's single ``device_get``).  The page
inventory comes from the allocator, so nothing is fetched to find what to
move.  :func:`install_migration` makes **no host sync**: fresh pages (the
block-table remap: page ids are worker-local), one page-write launch from
the packet into them, ``lens`` / keys / token / hidden written in place
(the decode round's CUDA graph reads these tensors), all ordered on the
decode session's stream.

A migration keeps streams bit-identical: a promoted slot's pool is
empty, and the decode round's per-slot math depends only on ``lens``,
pages, scales, keys, token, hidden and the request's own knobs, all of
which travel.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch import upload
from repro_torch.cache import latent_cache as LC
from repro_torch.core import offload
from repro_torch.distributed import compression as cmp
from repro_torch.serving import state as ES
from repro_torch.serving.scheduler import Request


@dataclasses.dataclass
class MigrationPacket:
    """One migrated request: everything the decode round consumes, on the
    host (pinned for a session on the card), in the tier's storage
    dtype."""
    rid: int
    prompt_len: int
    req: Request               # the live Request object travels with it
    n_pages: int               # host pages carrying prompt rows
    pages: torch.Tensor        # [L, n_pages, R, D] storage dtype
    scales: Optional[torch.Tensor]   # [L, n_pages, R, 1] f16 | None
    ikeys: tuple               # L x [plen, Di]
    t0: int                    # first token (promotion output)
    hidden: torch.Tensor       # [d_model] MTP draft seed
    tails: Optional[tuple] = None    # LRU-warmup replay input (do_warmup)
    submit_time: Optional[float] = None

    @property
    def wire_bytes(self) -> int:
        """Bytes on the inter-node wire (storage dtype == wire codec)."""
        return cmp.wire_nbytes(self.pages, self.scales, self.hidden,
                               *self.ikeys)


def _host(shape, dtype, device: torch.device) -> torch.Tensor:
    """A packet buffer: pinned when the session is on the card."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def _to_host(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` in a packet buffer, enqueued without waiting."""
    return _host(t.shape, t.dtype, device).copy_(t, non_blocking=True)


def host_wait(device: torch.device) -> None:
    """The pack's one host wait: everything enqueued on the current stream
    so far has landed.  Nothing on the CPU."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def pack_migration(session, slot: int, req: Request, t0, *,
                   tails: Optional[tuple] = None,
                   submit_time: Optional[float] = None) -> MigrationPacket:
    """Serialize one promoted slot into a :class:`MigrationPacket`.

    ``t0`` is the promotion's first token: a device scalar on the bucketed
    path (it rides the pack's one wait), a host int on the warmup path.
    Page ids come from the allocator; the pages (and scales) are copied by
    one page-gather launch straight into the packet, then the keys, the
    hidden, ``t0`` and the tails; one host wait ends the pack."""
    if session.allocator is None:
        raise ValueError("PD migration needs the paged host tier "
                         "(cfg.ess.offload_kv + paged_host)")
    dev = session.device
    plen = req.prompt_len
    n_used = LC.pages_for_len(session.cfg, plen)
    page_ids = session.allocator.owned(slot)[:n_used]
    assert len(page_ids) == n_used, \
        f"slot {slot} owns {len(page_ids)} pages, prompt needs {n_used}"
    caches = session.caches
    host, hs = caches.host_latent, caches.host_scales
    Lh, _, R, D = host.shape
    pages = _host((Lh, n_used, R, D), host.dtype, dev)
    scales = None if hs is None else _host((Lh, n_used, R, 1), hs.dtype,
                                           dev)
    ids = upload(torch.tensor(page_ids, dtype=torch.int64), dev)
    offload.gather_tier_pages(host, hs, ids, pages, scales)
    ikeys = tuple(_to_host(k[slot, :plen], dev) for k in caches.ikeys)
    hidden = _to_host(session.state.hidden[slot], dev)
    t0_h = _to_host(t0, dev) if isinstance(t0, torch.Tensor) else t0
    tails_h = None if tails is None else tuple(_to_host(t, dev)
                                               for t in tails)
    host_wait(dev)
    return MigrationPacket(
        rid=req.rid, prompt_len=plen, req=req, n_pages=n_used,
        pages=pages, scales=scales, ikeys=ikeys, t0=int(t0_h), hidden=hidden,
        tails=tails_h, submit_time=submit_time)


def can_accept(session, req: Request) -> bool:
    """Would ``install_migration`` succeed on this session now?  The
    admission gate's tests: a free slot, ``max_seq``, a pool-entry
    reservation and enough free host pages for prompt + max_new rows."""
    if not any(not s.active for s in session.sched.slots):
        return False
    if req.prompt_len + req.max_new_tokens > session.sched.max_seq:
        return False
    if session.free_pool_entries < session.pool_entries_per_slot:
        return False
    if session.allocator is not None \
            and not session.allocator.can_alloc(session.pages_needed(req)):
        return False
    return True


def _hold(session, packet: MigrationPacket) -> None:
    """Keep a packet's pinned buffers alive until the card has read them:
    the page write and the copies read them after ``install_migration``
    returns.  Packets whose reads are done are let go."""
    if session.device.type != "cuda":
        return
    done = torch.cuda.Event()
    done.record()
    held = [(e, p) for e, p in getattr(session, "_held_packets", [])
            if not e.query()]
    session._held_packets = held + [(done, packet)]


def install_migration(session, packet: MigrationPacket) -> int:
    """Install a migrated request into a free slot of ``session``.

    Allocates fresh pages (the block-table remap), writes the packet's
    pages and scale plane into them verbatim (one page-write launch over
    every layer), restores ``lens`` and the keys, adopts the request in
    the ``decode`` phase and delivers the first token (stop / length at
    ``t0`` finish at once, as at a promotion).  Every write is in place
    and enqueued on the session's stream: no host sync.  Returns the
    slot."""
    req = packet.req
    if session.allocator is None:
        raise ValueError("PD migration needs the paged host tier")
    assert can_accept(session, req), \
        f"install_migration: rid={req.rid} does not fit (route first)"
    slot = next(i for i, s in enumerate(session.sched.slots) if not s.active)
    plen = packet.prompt_len
    dev = session.device

    pages = session.allocator.alloc(slot, session.pages_needed(req))
    caches = session.caches
    LC.map_slot(caches, slot, pages)
    new_ids = upload(torch.tensor(pages[:packet.n_pages], dtype=torch.int64),
                     dev)
    offload.put_tier_pages(caches.host_latent, caches.host_scales, new_ids,
                           packet.pages, packet.scales)
    caches.lens[slot].fill_(plen)
    for k, ik in zip(caches.ikeys, packet.ikeys):
        k[slot, :plen].copy_(ik, non_blocking=True)
    session.free_pool_entries -= session.pool_entries_per_slot
    session._sample_pages()

    session.sched.adopt(req, slot)
    session._submit_round[req.rid] = session._round
    if packet.submit_time is not None:
        session._submit_time[req.rid] = packet.submit_time
    else:
        session._submit_time.setdefault(req.rid, time.perf_counter())
    session.outputs[req.rid] = []
    session._rounds_since_promote[slot] = 0
    ES.admit_slot(session.state, slot, req)
    ES.promote_slot(session.state, slot, packet.t0, packet.hidden)
    if session.do_warmup and packet.tails is not None:
        # the Sparse Memory Pool lives with decode: replay the prefill
        # worker's shipped warmup tails into this worker's pool
        session._warmup_slot(slot, tuple(t.to(dev, non_blocking=True)
                                         for t in packet.tails), plen)
    _hold(session, packet)
    session.report.events.append(
        f"round {session._round}: rid={req.rid} installed via PD handoff "
        f"(slot {slot}, {packet.n_pages} pages, {packet.wire_bytes} B)")
    done = session._deliver_first_token(slot, req, packet.t0)
    if done == "stop":
        session._handle_done([session.sched.finish(slot)])
    elif done == "length":
        session._handle_done(session.sched.record_tokens({slot: 0}))
    return slot


class InterNodeChannel:
    """Simulated inter-node fabric between prefill and decode workers.

    Deterministic step-granular delivery: a packet sent at cluster step
    ``t`` arrives at ``t + delay``, the fixed ``delay_steps`` or, from a
    cost model (:class:`repro_torch.simulator.costmodel.InterNodeModel`),
    ``latency_s + wire_bytes / bandwidth`` in serve steps of
    ``step_time_s``.  Delivery keeps send order within an arrival step.
    ``cancel`` drops an in-flight migration (an abort mid-handoff)."""

    def __init__(self, *, delay_steps: int = 0, model=None,
                 step_time_s: Optional[float] = None):
        self.delay_steps = max(0, int(delay_steps))
        self.model = model
        self.step_time_s = step_time_s
        self._now = 0
        self._inflight: list[tuple[int, int, MigrationPacket]] = []
        self._seq = 0
        self.packets_sent = 0
        self.payload_bytes = 0
        self.sim_transfer_s = 0.0

    @property
    def in_flight(self) -> list[MigrationPacket]:
        return [p for _, _, p in self._inflight]

    def delay_for(self, packet: MigrationPacket) -> int:
        if self.model is not None and self.step_time_s:
            t = self.model.latency_s + packet.wire_bytes / self.model.bandwidth
            return max(1, math.ceil(t / self.step_time_s))
        return self.delay_steps

    def send(self, packet: MigrationPacket) -> int:
        """Enqueue a migration; returns the cluster step it will arrive."""
        delay = self.delay_for(packet)
        if self.model is not None:
            self.sim_transfer_s += (self.model.latency_s
                                    + packet.wire_bytes / self.model.bandwidth)
        arrive = self._now + delay
        self._inflight.append((arrive, self._seq, packet))
        self._seq += 1
        self.packets_sent += 1
        self.payload_bytes += packet.wire_bytes
        return arrive

    def tick(self) -> list[MigrationPacket]:
        """Advance one cluster step; returns the packets arriving now (in
        send order)."""
        self._now += 1
        ready = sorted((e for e in self._inflight if e[0] <= self._now),
                       key=lambda e: e[1])
        self._inflight = [e for e in self._inflight if e[0] > self._now]
        return [p for _, _, p in ready]

    def cancel(self, rid: int) -> list[MigrationPacket]:
        """Drop the in-flight packets of one rid (abort mid-handoff)."""
        dropped = [p for _, _, p in self._inflight if p.rid == rid]
        self._inflight = [e for e in self._inflight if e[2].rid != rid]
        return dropped
