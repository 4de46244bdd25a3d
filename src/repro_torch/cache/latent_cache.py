"""ESS latent-cache state (counterpart of ``repro.cache.latent_cache``):
host tier + device pools + indexer cache.

* ``host_latent`` — the **Total Memory Pool**, a CPU tensor, **pinned**
  when the caches live on the card (the UVA kernels read and write it
  there).  Paged (default with ``offload_kv``): ``[L, NP, R, D]`` plus
  block tables ``[B, NB]``; dense: ``[L, B, max_seq, D]``.  Its payload
  is bf16 (the param dtype) or, with ``host_cache_dtype`` int8 / fp8,
  one byte per value beside ``host_scales`` (``[L, NP, R, 1]`` /
  ``[L, B, max_seq, 1]`` f16, one scale per row, pinned beside it).
* ``ikeys`` — per-layer ``[B, S, Di]`` Indexer-Cache tensors on the device,
  never offloaded.
* ``pools`` — per-layer :class:`repro_torch.core.lru_pool.PoolState`, the
  device-side **Sparse Memory Pool**.

The decode and prefill steps update ``host_latent``, ``ikeys`` and
``pools`` in place.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import resolve_device, upload
from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.distributed import compression as cmp
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.models.params import array_to_torch


class ESSCaches(NamedTuple):
    lens: torch.Tensor                 # [B] int64
    host_latent: torch.Tensor          # dense [L,B,S,D] | paged [L,NP,R,D]
    ikeys: list                        # L x [B, S, Di]
    pools: list                        # L x PoolState
    block_tables: Optional[torch.Tensor] = None   # [B, NB] (paged only)
    # quantized tier: per-row f16 scales, paged [L,NP,R,1] | dense
    # [L,B,S,1], in the same memory as host_latent (None = raw tier)
    host_scales: Optional[torch.Tensor] = None


def pool_entries(cfg: ArchConfig, max_seq: int) -> int:
    return LP.pool_entries_for(cfg.ess.sparse_memory_ratio, max_seq,
                               cfg.dsa.index_topk, cfg.ess.pool_min_entries)


def uses_paged_host(cfg: ArchConfig) -> bool:
    """Paged host tier is the default for offloaded configs."""
    return cfg.ess.offload_kv and cfg.ess.paged_host


def num_blocks(cfg: ArchConfig, max_seq: int) -> int:
    return -(-max_seq // cfg.ess.host_page_rows)


def pages_for_len(cfg: ArchConfig, n_rows: int) -> int:
    """Host pages a sequence of ``n_rows`` latent rows pins."""
    return -(-n_rows // cfg.ess.host_page_rows)


def host_storage_dtype(cfg: ArchConfig, dtype=torch.bfloat16):
    """(payload dtype, scale dtype | None) of the host latent tier."""
    name = cfg.ess.host_cache_dtype
    if name == "bf16":
        return dtype, None
    if name not in cmp.CACHE_QUANT_DTYPES:
        raise ValueError(f"unknown host_cache_dtype {name!r}; have "
                         f"bf16 | {sorted(cmp.CACHE_QUANT_DTYPES)}")
    return cmp.CACHE_QUANT_DTYPES[name], cmp.SCALE_DTYPE


def host_row_bytes(cfg: ArchConfig, dtype=torch.bfloat16) -> int:
    """Host bytes one latent row pins (payload + per-row scale): 1152 for
    bf16, 578 for int8 / fp8 at latent width 576."""
    qdt, sdt = host_storage_dtype(cfg, dtype)
    nbytes = cfg.mla.latent_dim * qdt.itemsize
    return nbytes + (sdt.itemsize if sdt is not None else 0)


def host_page_bytes(cfg: ArchConfig, dtype=torch.bfloat16) -> int:
    """Host bytes one page pins across all layers."""
    return cfg.num_layers * cfg.ess.host_page_rows * host_row_bytes(
        cfg, dtype)


def init_ess_caches(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                    *, device=None, num_pages: Optional[int] = None,
                    map_slots: bool = True) -> ESSCaches:
    """Decode caches for ``batch`` slots of up to ``max_seq`` tokens on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).  The host tier (and a quantized tier's scale plane)
    stays on the CPU, pinned for a CUDA device.

    Paged: ``num_pages`` pages (default ``batch * NB``).  ``map_slots``
    maps slot ``b`` onto pages ``[b*NB, (b+1)*NB)`` (the layout for
    fixed-batch callers); ``map_slots=False`` leaves every block table
    unmapped (-1), for a serve loop that maps pages at admission
    (:class:`HostPageAllocator`, :func:`map_slot`).

    Under a sharding context of ``n > 1`` data ranks each rank allocates
    its own ``batch / n`` slots (and ``num_pages / n`` pages): the tier
    and its scales a plain pinned tensor of the rank's rows (dense ``[L,
    B/n, S, D]``, paged its batch-major pages ``[L, NP/n, R, D]``, block
    tables of rank-local page ids), and ``lens``, ``ikeys``, the pools
    and the block tables DTensors sharded on batch, as
    :func:`abstract_ess_caches` lays them out."""
    nd = shd.data_ranks()
    if nd > 1:
        if batch % nd or (num_pages is not None and num_pages % nd):
            raise ValueError(f"{batch} slots / {num_pages} pages do not "
                             f"split over {nd} data ranks")
        with shd.use_sharding(None, None):
            local = init_ess_caches(
                cfg, batch // nd, max_seq, dtype, device=device,
                num_pages=None if num_pages is None else num_pages // nd,
                map_slots=map_slots)
        return on_mesh(local, shd.current().mesh, batch)
    dev = resolve_device(device)
    dtype = cfg.param_dtype if dtype is None else dtype
    qdt, sdt = host_storage_dtype(cfg, dtype)
    Lh, D, Di = cfg.num_layers, cfg.mla.latent_dim, cfg.dsa.index_dim
    P = pool_entries(cfg, max_seq)
    pin = dev.type == "cuda"

    block_tables = None
    if uses_paged_host(cfg):
        R = cfg.ess.host_page_rows
        NB = num_blocks(cfg, max_seq)
        NP = batch * NB if num_pages is None else num_pages
        lead = (Lh, NP, R)
        if not map_slots:
            block_tables = torch.full((batch, NB), -1, dtype=torch.int64,
                                      device=dev)
        elif NP < batch * NB:
            raise ValueError(f"identity slot mapping needs {batch * NB} "
                             f"pages, pool has {NP}; pass map_slots=False "
                             f"and admit through a HostPageAllocator")
        else:
            block_tables = torch.arange(batch * NB, dtype=torch.int64,
                                        device=dev).view(batch, NB)
    else:
        lead = (Lh, batch, max_seq)
        pin = pin and cfg.ess.offload_kv

    def tier(width, dt):
        t = torch.zeros(lead + (width,), dtype=dt, pin_memory=pin)
        return t if cfg.ess.offload_kv else t.to(dev)

    return ESSCaches(
        lens=torch.zeros((batch,), dtype=torch.int64, device=dev),
        host_latent=tier(D, qdt),
        ikeys=[torch.zeros((batch, max_seq, Di), dtype=dtype, device=dev)
               for _ in range(Lh)],
        pools=[LP.init_pool(batch, P, max_seq, D, dtype, dev)
               for _ in range(Lh)],
        block_tables=block_tables,
        host_scales=None if sdt is None else tier(1, sdt))


def on_mesh(local: ESSCaches, mesh, batch: int) -> ESSCaches:
    """One rank's caches of ``batch / n`` slots as its part of a global
    batch of ``batch`` over ``mesh``: the device leaves become DTensors
    sharded on batch over the data dimensions (the pools' clock
    replicated), with no collective; the host tier stays the rank's own
    plain tensor."""
    def b(t):
        return shd.from_local_batch(t, mesh, batch)

    def pool(p):
        return LP.PoolState(b(p.data), b(p.ids), b(p.last_use),
                            b(p.slot_of),
                            shd.from_local_replicated(p.step, mesh),
                            b(p.evicted))
    return local._replace(
        lens=b(local.lens), ikeys=[b(k) for k in local.ikeys],
        pools=[pool(p) for p in local.pools],
        block_tables=None if local.block_tables is None
        else b(local.block_tables))


def local_part(caches: ESSCaches) -> ESSCaches:
    """This rank's caches as plain tensors (the inverse of
    :func:`on_mesh`): its rows of every DTensor leaf, sharing their
    storage, so in-place updates reach the DTensors."""
    def loc(t):
        return t.to_local() if shd.is_dtensor(t) else t
    return caches._replace(
        lens=loc(caches.lens), ikeys=[loc(k) for k in caches.ikeys],
        pools=[LP.PoolState(*map(loc, p)) for p in caches.pools],
        block_tables=None if caches.block_tables is None
        else loc(caches.block_tables))


def abstract_ess_caches(cfg: ArchConfig, batch: int, max_seq: int,
                        dtype=torch.bfloat16) -> ESSCaches:
    """The dry run's :class:`ESSCaches`: ``meta`` leaves (DTensors on
    ``meta`` under a sharding context), the host tier (and its scales)
    tagged as host memory (:func:`~repro_torch.core.offload
    .abstract_host`), the rest device memory.

    Cache leaves are sharded over explicit mesh dimensions, batch over
    the data dimensions (``pod``, ``data``), whatever the activation
    profile: a weights-stationary profile unmaps the logical ``batch``,
    but the cache tier stays batch-parallel (``launch.steps.annotate``'s
    convention).  The paged tier's pages are laid out batch-major, so its
    page dim takes the data dimensions (``cache_batch``)."""
    Lh, D, Di = cfg.num_layers, cfg.mla.latent_dim, cfg.dsa.index_dim
    P = pool_entries(cfg, max_seq)
    qdt, sdt = host_storage_dtype(cfg, dtype)
    ctx = shd.current()
    on_mesh = ctx is not None and ctx.mesh is not None
    if on_mesh:
        data = tuple(a for a in ("pod", "data")
                     if a in ctx.mesh.mesh_dim_names)
        batch_entry = data if len(data) > 1 else (data[0] if data
                                                  else None)

    def dev(shape, dt, *axes):
        if not on_mesh:
            return shd.abstract(shape, dt)
        spec = tuple(batch_entry if a == "batch" else None for a in axes)
        spec = shd.prune_spec(spec, tuple(shape), ctx.mesh)
        return shd.abstract(shape, dt, shd.NamedSharding(ctx.mesh, spec))

    i64 = torch.int64
    block_tables, host_scales = None, None
    if uses_paged_host(cfg):
        R, NB = cfg.ess.host_page_rows, num_blocks(cfg, max_seq)
        lead, ax = (Lh, batch * NB, R), (None, "cache_batch", None, None)
        block_tables = dev((batch, NB), i64, "batch", None)
    else:
        lead, ax = (Lh, batch, max_seq), (None, "batch", None, None)

    def tier(width, dt):
        if cfg.ess.offload_kv:
            return offload.abstract_host(lead + (width,), dt, *ax)
        return dev(lead + (width,), dt, None, "batch", None, None)
    host = tier(D, qdt)
    if sdt is not None:
        host_scales = tier(1, sdt)

    def pool():
        return LP.PoolState(
            data=dev((batch, P, D), dtype, "batch", None, None),
            ids=dev((batch, P), i64, "batch", None),
            last_use=dev((batch, P), i64, "batch", None),
            slot_of=dev((batch, max_seq), i64, "batch", None),
            step=dev((), i64),
            evicted=dev((batch,), i64, "batch"))
    return ESSCaches(
        lens=dev((batch,), i64, "batch"),
        host_latent=host,
        ikeys=[dev((batch, max_seq, Di), dtype, "batch", None, None)
               for _ in range(Lh)],
        pools=[pool() for _ in range(Lh)],
        block_tables=block_tables,
        host_scales=host_scales)


# ---------------------------------------------------------------------------
# Slot lifecycle (continuous batching)
# ---------------------------------------------------------------------------
#
# Every edit is in place: a decode round replayed from a CUDA graph reads
# the same lens, pools and block-table tensors it was captured with.

def reset_slot(caches: ESSCaches, slot: int) -> ESSCaches:
    """Full per-slot reset of a recycled decode slot, in place: ``lens``
    and every layer's pool maps (``ids`` / ``last_use`` / ``slot_of``).
    Pool ``data`` rows become unreachable and are left as they are (an
    admission overwrites them).  ``fill_`` of a Python scalar: no host
    copy (an indexed assignment of a scalar would copy it from the host
    and wait for the card)."""
    for p in caches.pools:
        p.ids[slot].fill_(-1)
        p.last_use[slot].fill_(-1)
        p.slot_of[slot].fill_(-1)
    caches.lens[slot].fill_(0)
    return caches


def map_slot(caches: ESSCaches, slot: int,
             pages: Sequence[int]) -> ESSCaches:
    """Install a slot's block table from an allocator's page list (the
    table's row is written in place; dense tiers have none)."""
    if caches.block_tables is None:
        return caches
    NB = caches.block_tables.shape[1]
    if len(pages) > NB:
        raise ValueError(f"{len(pages)} pages > {NB} blocks per slot")
    bt = caches.block_tables
    row = torch.tensor(list(pages) + [-1] * (NB - len(pages)),
                       dtype=bt.dtype)
    bt[slot].copy_(upload(row, bt.device))
    return caches


def pages_owned_mask(block_tables: torch.Tensor,
                     num_pages: int) -> torch.Tensor:
    """[NP] bool — physical pages mapped by any row of ``block_tables``."""
    flat = block_tables.reshape(-1)
    mask = torch.zeros((num_pages + 1,), dtype=torch.bool,
                       device=flat.device)
    mask.index_fill_(0, torch.where(flat >= 0, flat, num_pages), True)
    return mask[:num_pages]


def unmap_slot(caches: ESSCaches, slot: int) -> ESSCaches:
    if caches.block_tables is not None:
        caches.block_tables[slot].fill_(-1)
    return caches


class HostPageAllocator:
    """Host-side free list for the global page pool (deterministic FIFO;
    the port's own copy of the reference's).

    The serve loop owns one: admission asks ``can_alloc`` (the free-page
    gate), maps the returned pages into the slot's block table, and
    ``release`` returns them when the slot finishes or is preempted."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: deque[int] = deque(range(num_pages))
        self._owned: dict[int, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, slot: int, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise RuntimeError(f"allocator: want {n} pages, "
                               f"{len(self._free)} free")
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns pages")
        pages = [self._free.popleft() for _ in range(n)]
        self._owned[slot] = pages
        return pages

    def release(self, slot: int) -> list[int]:
        pages = self._owned.pop(slot, [])
        self._free.extend(pages)
        return pages

    def owned(self, slot: int) -> list[int]:
        """Pages one slot owns, in allocation order."""
        return list(self._owned.get(slot, []))


def from_jax_caches(jc, device="cpu") -> ESSCaches:
    """A reference ``ESSCaches`` with numpy leaves (``jax.tree.map(
    np.asarray, caches)``; fp8 payload and f16 scales included) -> the
    port's, bit for bit.  Indices become int64; the host tier (and scale
    plane) stays on the CPU, pinned when ``device`` is the card; the rest
    goes to ``device``.  Pools start with a zero eviction counter."""
    dev = torch.device(device)

    def tier(a):
        if a is None:
            return None
        t = array_to_torch(a)
        return t.pin_memory() if dev.type == "cuda" else t

    def i64(a):
        return array_to_torch(a, dev).long()
    pools = [LP.PoolState(array_to_torch(p.data, dev), i64(p.ids),
                          i64(p.last_use), i64(p.slot_of), i64(p.step),
                          torch.zeros(p.ids.shape[0], dtype=torch.int64,
                                      device=dev))
             for p in jc.pools]
    return ESSCaches(
        lens=i64(jc.lens), host_latent=tier(jc.host_latent),
        ikeys=[array_to_torch(k, dev) for k in jc.ikeys], pools=pools,
        block_tables=None if jc.block_tables is None
        else i64(jc.block_tables),
        host_scales=tier(jc.host_scales))


def tier_nbytes(caches: ESSCaches) -> int:
    """Bytes the host tier holds: payload plus scale plane."""
    return cmp.wire_nbytes(caches.host_latent, caches.host_scales)


# ---------------------------------------------------------------------------
# Paged <-> packed views, and the admission graft
# ---------------------------------------------------------------------------

def slot_latents(caches: ESSCaches, slot: int) -> torch.Tensor:
    """All host-tier latent rows of one slot, packed ``[L, NB*R, D]`` (paged)
    or ``[L, max_seq, D]`` (dense), on the caches' device; bf16 for a
    quantized tier.  Rows of unmapped pages are zero.

    On the card the paged tier is read by the page-gather kernels, one
    launch for all layers (the fused dequant variant for a quantized tier);
    the dense tier by the row-gather kernels over the slot's rows."""
    host, scales = caches.host_latent, caches.host_scales
    dev = caches.lens.device
    if caches.block_tables is None:
        Lh, Bt, S, D = host.shape
        ids = ((torch.arange(Lh, device=dev)[:, None] * Bt + slot) * S
               + torch.arange(S, device=dev)[None])               # [L,S]
        if scales is None:
            return gops.gather_rows(host.view(-1, D), ids)
        return gops.gather_rows_dequant(host.view(-1, D), scales.view(-1, 1),
                                        ids, torch.bfloat16)
    Lh, NP, R, D = host.shape
    bt = caches.block_tables[slot]                                # [NB]
    safe = bt.clamp(0, NP - 1)
    if scales is None:
        out = gops.gather_pages(host.view(Lh, NP * R, D), safe, R)
    else:
        out = gops.gather_pages_dequant(host.view(Lh, NP * R, D),
                                        scales.view(Lh, NP * R, 1), safe, R,
                                        torch.bfloat16)
    valid = (bt >= 0).repeat_interleave(R)                        # [NB*R]
    return torch.where(valid[None, :, None], out, torch.zeros_like(out))


def graft_pool_into(full: LP.PoolState, one: LP.PoolState,
                    slot: int) -> LP.PoolState:
    """Install a batch-1 pool (a donor prefill) as ``slot`` of a shared
    pool, in place.  The donor's LRU stamps are clamped to the shared
    pool's clock so its entries do not look hotter than resident ones."""
    lu = torch.minimum(one.last_use[0], full.step)
    full.data[slot] = one.data[0].to(full.data.dtype)
    full.ids[slot] = one.ids[0]
    full.last_use[slot] = torch.where(one.last_use[0] < 0, -1, lu)
    full.slot_of[slot] = one.slot_of[0]
    return full


def graft_slot(caches: ESSCaches, slot: int, donor: ESSCaches,
               n_rows: int) -> ESSCaches:
    """Copy ``donor``'s sequence 0 (a batch-1 prefill) into ``slot``.

    Writes the donor's first ``n_rows`` host-tier rows through the target
    slot's block table (paged) or batch row (dense), requantized for a
    quantized target, and grafts the indexer cache and each layer's pool.
    The tier, indexer cache and pools change in place; the returned caches
    carry the new ``lens``."""
    rows = slot_latents(donor, 0)[:, :n_rows]
    ids = torch.arange(n_rows, device=caches.lens.device)[None]   # [1, n]
    offload.scatter_tier_rows_stacked(
        caches.host_latent, caches.host_scales, ids, rows[:, None],
        slot_mask=None, batch_offset=slot, block_table=caches.block_tables)
    for full, one in zip(caches.ikeys, donor.ikeys):
        full[slot] = one[0].to(full.dtype)
    for full, one in zip(caches.pools, donor.pools):
        graft_pool_into(full, one, slot)
    lens = caches.lens.clone()
    lens[slot] = n_rows
    return caches._replace(lens=lens)
