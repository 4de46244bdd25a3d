"""Host tier of the latent cache and the FlashTrans transfers (paper
section 3.1; counterpart of ``repro.core.offload``).

On the card the tier is a **pinned** CPU tensor (this replaces the
reference's ``pinned_host`` memory kind).  Both directions run as CUDA
kernels on the caller's stream through the tier's UVA mapping:

* :func:`host_gather_rows` translates positions to physical rows on the
  device and calls the row-gather kernel, which reads the pinned rows
  directly (no host-side gather, no staging copy);
* :func:`host_scatter_rows` writes new rows with the scatter kernel, so a
  layer's write is ordered before that layer's gather by the stream alone,
  with no host synchronisation.

The scatters update the tier **in place** and return it.  Two layouts, as
in the reference: dense ``[L,B,S,D]`` and paged ``[L,NP,R,D]`` with block
tables ``[B,NB]``.  A quantized tier (``host_scales``, int8/fp8 payload
plus an f16 scale per row) moves compressed both ways:
:func:`gather_tier_rows` is one fused gather-dequant launch that widens
only the fetched rows, and :func:`scatter_tier_rows` quantizes at append
width on the device before writing payload and scales.

Over several data ranks (:mod:`repro_torch.distributed.sharding`) each
rank's tier holds its own batch rows only: dense ``[L, B/n, S, D]``, paged
its batch-major pages ``[L, NP/n, R, D]`` with rank-local page ids in the
block tables (:func:`~repro_torch.cache.latent_cache.init_ess_caches`), a
plain pinned tensor (the dry run's: a ``meta`` DTensor, whose local shard
is the rank's).  The ids, rows and block tables of a whole-batch call are
DTensors sharded on batch; each route takes their local tensors, runs the
same translation and kernel over the rank's rows and returns rows as a
DTensor sharded on batch, with no collective (the reference's mesh
branches, which keep the host buffer batch-sharded: "zero host-buffer
all-gathers").  A call on one slot (a per-slot prefill) runs on the
slot's rank with plain tensors and a rank-local ``batch_offset``.  On one
card the tier is the whole tier.  :func:`abstract_host` and
:func:`host_sharding_for` build the dry run's host-tier leaves
(``memory_kind`` ``"pinned_host"``).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import compression as cmp
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.gather_cache import ops as gops

#: the memory kind of the host tier's abstract leaves
HOST = "pinned_host"


def host_sharding_for(shape, axes):
    """Shape-aware host-tier sharding under the active context (pruning
    axes that do not divide: a batch of 1 cannot take the data axis);
    None outside one."""
    ctx = shd.current()
    if ctx is None or ctx.mesh is None:
        return None
    return ctx.sharding_for(tuple(shape), axes, memory_kind=HOST)


def abstract_host(shape, dtype, *axes) -> torch.Tensor:
    """A host-tier leaf for the dry run: a ``meta`` tensor (a DTensor on
    ``meta`` under a context) tagged ``memory_kind == "pinned_host"``."""
    return shd.abstract(shape, dtype, host_sharding_for(shape, axes),
                        memory_kind=HOST)


class _OnRank:
    """One rank's side of a route call: the local tier (and scales), the
    local ids and block table, and ``wrap`` for what the route returns.
    Without a DTensor among them everything is taken as it is.  DTensor
    ids (batch at dim ``bdim``) are the whole batch: their rows of it are
    this rank's rows of the tier, so ``batch_offset`` must be 0."""

    def __init__(self, host, scales, ids, block_table, batch_offset,
                 bdim: int = 0):
        self.host, self.scales = host, scales
        self.ids, self.block_table = ids, block_table
        self.batch_offset, self.mesh = batch_offset, None
        dts = [t for t in (ids, block_table, host, scales)
               if shd.is_dtensor(t)]
        if not dts:
            return
        self.mesh, self.bdim = dts[0].device_mesh, bdim
        if shd.is_dtensor(ids):
            if int(batch_offset):
                raise ValueError("a DTensor batch of ids is the whole "
                                 "batch: batch_offset must be 0")
            self.n = ids.shape[bdim]
            self.ids = shd.to_local_batch(ids, bdim)
        self.block_table = shd.to_local_batch(block_table)
        # the tier's own shard, never moved: a plain tensor is the rank's
        self.host = host.to_local() if shd.is_dtensor(host) else host
        self.scales = scales.to_local() if shd.is_dtensor(scales) \
            else scales

    def local(self, t, dim: int = 0):
        """Another batch-major argument (rows, a mask, an ``out``) at this
        rank's rows; an ``out`` DTensor must already be there, so that the
        route writes into its storage."""
        return shd.to_local_batch(t, dim) if self.mesh is not None else t

    def wrap(self, t):
        """Rows this rank gathered -> a DTensor of the ids' global batch."""
        if self.mesh is None or not hasattr(self, "n"):
            return t
        return shd.from_local_batch(t, self.mesh, self.n, self.bdim)


def _batch_slice(t: torch.Tensor, batch_offset: int, B: int) -> torch.Tensor:
    # dynamic_slice semantics: the start is clamped so the slice fits
    start = min(max(int(batch_offset), 0), t.shape[0] - B)
    return t[start:start + B]


def _paged_phys(ids: torch.Tensor, block_table: torch.Tensor, page_rows: int,
                num_pages: int, batch_offset: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence positions -> physical rows of the flat ``[NP*R, D]`` pool.

    ids [B,M] (-1 padding), block_table [B_total, NB].  Returns (phys [B,M],
    valid [B,M] — in range *and* mapped)."""
    B = ids.shape[0]
    bt = _batch_slice(block_table, batch_offset, B)
    cap = bt.shape[1] * page_rows
    safe = ids.clamp(0, cap - 1)
    page = bt.gather(1, safe // page_rows)
    valid = (ids >= 0) & (ids < cap) & (page >= 0)
    phys = page.clamp(0, num_pages - 1) * page_rows + safe % page_rows
    return phys, valid


def _layer_flat(host_cache: torch.Tensor, layer: int) -> torch.Tensor:
    """One layer of the tier ([L,...] stacked or not) as a flat [rows, D]
    view."""
    cl = host_cache[layer] if host_cache.dim() == 4 else host_cache
    return cl.reshape(-1, cl.shape[-1])


def _dense_flat_ids(ids: torch.Tensor, S: int, B_total: int,
                    batch_offset: int, valid: torch.Tensor) -> torch.Tensor:
    B = ids.shape[0]
    start = min(max(int(batch_offset), 0), B_total - B)
    b = torch.arange(B, device=ids.device)[:, None] + start
    return torch.where(valid, b * S + ids.clamp(0, S - 1), -1)


def _gather_flat_ids(host_cache: torch.Tensor, ids: torch.Tensor,
                     batch_offset: int, block_table: torch.Tensor | None
                     ) -> torch.Tensor:
    """Positions ids [B,M] -> rows of one layer's flat tier view (-1 where
    padding or unmapped)."""
    if block_table is not None:
        R, NP = host_cache.shape[-2], host_cache.shape[-3]
        phys, valid = _paged_phys(ids, block_table, R, NP, batch_offset)
        return torch.where(valid, phys, -1)
    S, Bt = host_cache.shape[-2], host_cache.shape[-3]
    return _dense_flat_ids(ids, S, Bt, batch_offset, ids >= 0)


def host_gather_rows(host_cache: torch.Tensor, ids: torch.Tensor, *,
                     layer: int = 0, batch_offset: int = 0,
                     block_table: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """FlashTrans fetch: ids [B,M] (-1 padding) -> rows [B,M,D] on
    ``ids.device`` (into ``out`` if given); unmapped or padding rows are
    zero.

    dense: host_cache [B,S,D] / [L,B,S,D]; paged: [NP,R,D] / [L,NP,R,D]
    with ``block_table``."""
    r = _OnRank(host_cache, None, ids, block_table, batch_offset)
    flat_ids = _gather_flat_ids(r.host, r.ids, r.batch_offset,
                                r.block_table)
    return r.wrap(gops.gather_rows(_layer_flat(r.host, layer), flat_ids,
                                   out=r.local(out)))


def _scatter_targets(host_cache, ids, block_table, batch_offset, drop_oob):
    if block_table is not None:
        R, NP = host_cache.shape[-2], host_cache.shape[-3]
        phys, valid = _paged_phys(ids, block_table, R, NP, batch_offset)
        return torch.where(valid, phys, -1), NP * R
    S, Bt = host_cache.shape[-2], host_cache.shape[-3]
    valid = ids >= 0
    if drop_oob:
        valid = valid & (ids < S)
    return _dense_flat_ids(ids, S, Bt, batch_offset, valid), Bt * S


def host_scatter_rows(host_cache: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor, *,
                      slot_mask: torch.Tensor | None, layer: int = 0,
                      batch_offset: int = 0,
                      block_table: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Write rows [B,Q,D] at positions ids [B,Q] (-1 = masked) into one
    layer of the tier, in place; returns the tier.

    ``slot_mask`` [B] (required, keyword-only; ``None`` = every row live)
    drops masked rows' writes.  Paged writes to unmapped pages drop."""
    if slot_mask is not None:
        ids = torch.where(slot_mask[:, None], ids, -1)
    r = _OnRank(host_cache, None, ids, block_table, batch_offset)
    tgt, _ = _scatter_targets(r.host, r.ids, r.block_table, r.batch_offset,
                              drop_oob=False)
    rows = r.local(rows)
    gops.scatter_rows(_layer_flat(r.host, layer),
                      tgt.reshape(-1), rows.reshape(-1, rows.shape[-1]))
    return host_cache


def _stacked_flat(host_cache: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A stacked tier ``[L, ...rows..., D]`` as one flat ``[N, D]`` view of
    its storage, and the rows between two layers' starts.  Each layer's
    rows are contiguous; the layers need not be (a TBO half's slice of a
    dense tier): the view spans from layer 0's first row to the last
    layer's last, and a layer's flat id ``i`` is row ``l * stride + i``."""
    D = host_cache.shape[-1]
    per_layer = host_cache[0].numel() // D
    stride = host_cache.stride(0) // D
    if host_cache.stride(0) % D or not host_cache[0].is_contiguous():
        raise ValueError("a stacked tier's layers must be contiguous rows")
    span = (host_cache.shape[0] - 1) * stride + per_layer
    return host_cache.as_strided((span, D), (D, 1)), stride


def _stacked_ids(flat: torch.Tensor, stride: int) -> torch.Tensor:
    """Per-layer flat ids ``[L, ...]`` (-1 dropped) -> ids into the
    :func:`_stacked_flat` view."""
    off = torch.arange(flat.shape[0], device=flat.device) * stride
    off = off.view(-1, *([1] * (flat.dim() - 1)))
    return torch.where(flat >= 0, flat + off, -1)


def host_scatter_rows_stacked(host_cache: torch.Tensor, ids: torch.Tensor,
                              rows: torch.Tensor, *,
                              slot_mask: torch.Tensor | None,
                              batch_offset: int = 0,
                              block_table: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Write rows [L,B,Q,D] at the same positions ids [B,Q] into every layer
    of a stacked tier in one launch, in place; returns the tier."""
    if slot_mask is not None:
        ids = torch.where(slot_mask[:, None], ids, -1)
    r = _OnRank(host_cache, None, ids, block_table, batch_offset)
    Lh, D = r.host.shape[0], r.host.shape[-1]
    tgt, _ = _scatter_targets(r.host, r.ids, r.block_table, r.batch_offset,
                              drop_oob=True)
    flat, stride = _stacked_flat(r.host)
    tgt_all = _stacked_ids(tgt[None].expand(Lh, *tgt.shape), stride)
    gops.scatter_rows(flat, tgt_all.reshape(-1),
                      r.local(rows, 1).reshape(-1, D))
    return host_cache


def gather_into_slab(host_cache: torch.Tensor,
                     host_scales: torch.Tensor | None, ids: torch.Tensor, *,
                     slot_mask: torch.Tensor | None, batch_offset: int = 0,
                     block_table: torch.Tensor | None = None,
                     out: torch.Tensor | None = None,
                     out_scales: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The pipelined round's staging gather: per-layer positions ``ids
    [L,B,P]`` (-1 = not staged) -> the tier's rows ``[L,B,P,D]`` in its
    storage dtype, and a quantized tier's scales ``[L,B,P,1]`` (None for a
    raw tier), on ``ids.device`` (into ``out`` / ``out_scales`` if given).
    One launch over every layer (:func:`gops.gather_rows_raw`, the direct
    route's warp per id with no widening), so a staged row is the bytes
    the synchronous gather would read.  ``slot_mask`` [B] (required,
    keyword-only; None = every slot) drops masked slots' ids."""
    if slot_mask is not None:
        ids = torch.where(slot_mask[None, :, None], ids, -1)
    r = _OnRank(host_cache, host_scales, ids, block_table, batch_offset,
                bdim=1)
    Lh, B, P = r.ids.shape
    per = _gather_flat_ids(r.host, r.ids.permute(1, 0, 2).reshape(B, -1),
                           r.batch_offset, r.block_table)
    flat, stride = _stacked_flat(r.host)
    idx = _stacked_ids(per.view(B, Lh, P).permute(1, 0, 2).contiguous(),
                       stride)
    sflat = None if r.scales is None else _stacked_flat(r.scales)[0]
    rows, sc = gops.gather_rows_raw(flat, sflat, idx, out=r.local(out, 1),
                                    out_scales=r.local(out_scales, 1))
    return r.wrap(rows), None if sc is None else r.wrap(sc)


def scatter_from_slab(host_cache: torch.Tensor,
                      host_scales: torch.Tensor | None, ids: torch.Tensor,
                      rows: torch.Tensor, scales: torch.Tensor | None, *,
                      slot_mask: torch.Tensor | None, batch_offset: int = 0,
                      block_table: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The pipelined round's commit: every layer's appended rows ``[L,B,Q,D]``
    (already in the tier's dtype: a quantized tier's payload, quantized
    once in the layer loop, with its ``scales [L,B,Q,1]``) written at the
    positions ``ids [B,Q]`` in one stacked launch per plane; -1 drops.  In
    place; returns ``(tier, scales)``."""
    kw = dict(slot_mask=slot_mask, batch_offset=batch_offset,
              block_table=block_table)
    host_scatter_rows_stacked(host_cache, ids, rows, **kw)
    if host_scales is not None:
        host_scatter_rows_stacked(host_scales, ids, scales, **kw)
    return host_cache, host_scales


def tier_rows_dtype(host_cache: torch.Tensor,
                    host_scales: torch.Tensor | None) -> torch.dtype:
    """The dtype of the rows :func:`gather_tier_rows` returns without an
    ``out_dtype``: the raw tier's own, bf16 from a quantized tier."""
    return host_cache.dtype if host_scales is None else torch.bfloat16


def gather_tier_rows(host_cache: torch.Tensor,
                     host_scales: torch.Tensor | None, ids: torch.Tensor, *,
                     layer: int = 0, batch_offset: int = 0,
                     block_table: torch.Tensor | None = None,
                     out_dtype=None, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Tier fetch, ids [B,M] -> rows [B,M,D] on ``ids.device``.

    ``host_scales is None`` is the raw tier (:func:`host_gather_rows`).  A
    quantized tier takes one fused gather-dequant launch over payload and
    scales and returns ``out_dtype`` rows, **bf16** when ``out_dtype`` is
    None (the reference's decode miss fetch passes none, whatever the
    param dtype).  Padding and unmapped rows are exact zeros either way.
    ``out`` (``[B,M,D]`` of :func:`tier_rows_dtype`, without
    ``out_dtype``) receives the rows: the caller's memory, e.g. allocated
    on the stream that consumes them while the fetch runs on another."""
    if host_scales is None:
        rows = host_gather_rows(host_cache, ids, layer=layer,
                                batch_offset=batch_offset,
                                block_table=block_table, out=out)
        return rows if out_dtype is None else rows.to(out_dtype)
    r = _OnRank(host_cache, host_scales, ids, block_table, batch_offset)
    flat_ids = _gather_flat_ids(r.host, r.ids, r.batch_offset,
                                r.block_table)
    return r.wrap(gops.gather_rows_dequant(
        _layer_flat(r.host, layer), _layer_flat(r.scales, layer),
        flat_ids, torch.bfloat16 if out_dtype is None else out_dtype,
        out=r.local(out)))


def scatter_tier_rows(host_cache: torch.Tensor,
                      host_scales: torch.Tensor | None, ids: torch.Tensor,
                      rows: torch.Tensor, *,
                      slot_mask: torch.Tensor | None, layer: int = 0,
                      batch_offset: int = 0,
                      block_table: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Tier write-back of rows [B,Q,D] at positions ids [B,Q], in place;
    returns ``(tier, scales)``.  A quantized tier quantizes the rows on
    their device at append width, then writes the payload and the scale
    plane, so only compressed bytes cross the link."""
    kw = dict(slot_mask=slot_mask, layer=layer, batch_offset=batch_offset,
              block_table=block_table)
    if host_scales is None:
        return host_scatter_rows(host_cache, ids, rows, **kw), None
    q, s = cmp.quantize_rows(rows, host_cache.dtype)
    host_scatter_rows(host_cache, ids, q, **kw)
    host_scatter_rows(host_scales, ids, s, **kw)
    return host_cache, host_scales


def scatter_tier_rows_stacked(host_cache: torch.Tensor,
                              host_scales: torch.Tensor | None,
                              ids: torch.Tensor, rows: torch.Tensor, *,
                              slot_mask: torch.Tensor | None,
                              batch_offset: int = 0,
                              block_table: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """All-layer write-back (admission graft): rows [L,B,Q,D] at the same
    positions ids [B,Q] in every layer, quantized per row on their device
    for a quantized tier; one stacked payload write and one stacked scale
    write.  In place; returns ``(tier, scales)``."""
    kw = dict(slot_mask=slot_mask, batch_offset=batch_offset,
              block_table=block_table)
    if host_scales is None:
        return host_scatter_rows_stacked(host_cache, ids, rows, **kw), None
    q, s = cmp.quantize_rows(rows, host_cache.dtype)
    host_scatter_rows_stacked(host_cache, ids, q, **kw)
    host_scatter_rows_stacked(host_scales, ids, s, **kw)
    return host_cache, host_scales


def gather_tier_pages(host_cache: torch.Tensor,
                      host_scales: torch.Tensor | None, ids: torch.Tensor,
                      out: torch.Tensor, out_scales: torch.Tensor | None
                      ) -> None:
    """The PD migration's pack: pages ``ids [n]`` (physical, on the caller's
    device) of a paged tier ``[L, NP, R, D]`` -> ``out [L, n, R, D]`` in
    the tier's storage dtype, and a quantized tier's scale plane ->
    ``out_scales [L, n, R, 1]``, raw: one :func:`gops.gather_pages` launch
    over every layer and both planes, ordered on the caller's stream after
    the tier writes before it.  ``out`` may be pinned host memory (the
    packet), written through its UVA pointer."""
    Lh, NP, R, D = host_cache.shape
    n = ids.shape[0]
    kw = dict(out=out.view(Lh, n * R, D))
    if host_scales is not None:
        kw.update(scales=host_scales.view(Lh, NP * R, 1),
                  out_scales=out_scales.view(Lh, n * R, 1))
    gops.gather_pages(host_cache.view(Lh, NP * R, D), ids, R, **kw)


def put_tier_pages(host_cache: torch.Tensor,
                   host_scales: torch.Tensor | None, ids: torch.Tensor,
                   pages: torch.Tensor, scales: torch.Tensor | None) -> None:
    """The PD migration's install, the inverse of :func:`gather_tier_pages`:
    ``pages [L, n, R, D]`` (and ``scales [L, n, R, 1]``) -> pages ``ids
    [n]`` of the tier, verbatim, in place: one :func:`gops.put_pages`
    launch over every layer and both planes on ``ids``' device, ordered on
    the caller's stream.  ``pages`` may be pinned host memory (the
    packet), read through its UVA pointer."""
    Lh, NP, R, D = host_cache.shape
    n = pages.shape[1]
    kw = {}
    if host_scales is not None:
        if scales is None:
            raise ValueError("a quantized tier needs the packet's scale "
                             "plane")
        kw = dict(dst_scales=host_scales.view(Lh, NP * R, 1),
                  src_scales=scales.reshape(Lh, n * R, 1))
    gops.put_pages(host_cache.view(Lh, NP * R, D), ids,
                   pages.reshape(Lh, n * R, D), R, **kw)
