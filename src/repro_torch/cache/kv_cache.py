"""Paged GQA KV cache (counterpart of ``repro.cache.kv_cache``): the
substrate of the generalized ESS pool on non-MLA architectures and of
slot management in continuous batching.

A sequence's *logical* cache is a list of fixed-size pages scattered in a
global page pool; a per-sequence page table maps logical block ->
physical page.  Unlike the reference's pure functions, :func:`append_token`
and :func:`release_sequence` update the tensors in place and return the
same :class:`PagedKV`.  The reference gathers with XLA ``take`` (no
Pallas kernel), so this is torch indexing on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device


class PagedKV(NamedTuple):
    pages_k: torch.Tensor      # [NPAGES, PAGE, KV, HD]
    pages_v: torch.Tensor      # [NPAGES, PAGE, KV, HD]
    page_table: torch.Tensor   # [B, MAX_BLOCKS] physical page id (-1 empty)
    lens: torch.Tensor         # [B] int64
    free_head: torch.Tensor    # [] next free page (bump allocator)


def init_paged(npages: int, page: int, kv_heads: int, head_dim: int,
               batch: int, max_blocks: int, dtype=torch.bfloat16,
               device=None) -> PagedKV:
    """An empty paged cache on ``device`` (the card by default)."""
    dev = resolve_device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    shape = (npages, page, kv_heads, head_dim)
    return PagedKV(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   torch.full((batch, max_blocks), -1, **i64),
                   torch.zeros((batch,), **i64), torch.zeros((), **i64))


def append_token(kv: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> PagedKV:
    """Append one token per sequence (k_new / v_new [B, KV, HD]), in place.
    A sequence at a page boundary takes the next free page of the bump
    allocator, in batch order (an exclusive cumsum ranks them); freeing is
    the host-side scheduler's (it rebuilds page tables on eviction)."""
    B, page = k_new.shape[0], kv.pages_k.shape[1]
    bi = torch.arange(B, device=k_new.device)
    blk, off = kv.lens // page, kv.lens % page
    need = (off == 0).long()
    new_page = kv.free_head + need.cumsum(0) - need
    kv.page_table[bi, blk] = torch.where(need == 1, new_page,
                                         kv.page_table[bi, blk])
    phys = kv.page_table[bi, blk]
    kv.pages_k[phys, off] = k_new.to(kv.pages_k.dtype)
    kv.pages_v[phys, off] = v_new.to(kv.pages_v.dtype)
    kv.lens.add_(1)
    kv.free_head.add_(need.sum())
    return kv


def gather_kv(kv: PagedKV, max_seq: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sequence contiguous k / v [B, max_seq, KV, HD] and the valid
    mask [B, max_seq] (the decode attention's input); ``max_seq`` a
    multiple of the page.  Empty table entries read page 0, masked."""
    B = kv.page_table.shape[0]
    page = kv.pages_k.shape[1]
    nb = max_seq // page
    pt = kv.page_table[:, :nb].clamp_min(0)
    k = kv.pages_k[pt].reshape(B, nb * page, *kv.pages_k.shape[2:])
    v = kv.pages_v[pt].reshape(B, nb * page, *kv.pages_v.shape[2:])
    valid = torch.arange(nb * page, device=pt.device)[None, :] \
        < kv.lens[:, None]
    return k, v, valid


def release_sequence(kv: PagedKV, seq: int) -> PagedKV:
    """Host-side eviction: clear slot ``seq``'s table and length, in place
    (its pages are recycled by the scheduler's compaction pass)."""
    kv.page_table[seq].fill_(-1)
    kv.lens[seq].fill_(0)
    return kv
