"""Plain PyTorch versions of the row / page gather and scatter kernels."""

from __future__ import annotations

import torch

from repro_torch.distributed.compression import dequantize_rows


def gather_rows_ref(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """cache [S, D], ids [...] -> rows [..., D]: ``cache[clip(ids)]`` with
    zero rows where ``ids < 0``."""
    safe = ids.clamp(0, cache.shape[0] - 1)
    rows = cache[safe]
    return torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))


def gather_rows_raw_ref(cache: torch.Tensor, scales: torch.Tensor | None,
                        ids: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`gather_rows_ref` of the stored bytes, and of the f16 scale
    plane ``scales [S, 1]`` beside them (zero scales where ``ids < 0``)."""
    return (gather_rows_ref(cache, ids),
            None if scales is None else gather_rows_ref(scales, ids))


def rows_read(ids: torch.Tensor, s: int, staged: bool) -> int:
    """Tier rows a row gather over ``s`` rows reads for ``ids``: every id
    ``>= 0`` on the direct route, each distinct clipped one once on the
    staged route."""
    live = ids[ids >= 0]
    return int(live.clamp_max(s - 1).unique().numel() if staged
               else live.numel())


def scatter_rows_ref(dst: torch.Tensor, tgt: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """In place: ``dst[tgt[i]] = rows[i]`` where ``0 <= tgt[i] < len(dst)``;
    the other rows are dropped.  dst [N, D], tgt [M], rows [M, D].

    Fixed shapes (no boolean index, so it runs on ``meta``): a dropped
    row is written onto the last kept row's target with that row's value,
    which the kept write leaves in place whatever the order (the last write
    to a row wins, as before); with nothing kept, onto row 0 with its
    current value."""
    N = dst.shape[0]
    if tgt.numel() == 0:
        return dst
    keep = (tgt >= 0) & (tgt < N)
    pos = torch.arange(tgt.shape[0], device=tgt.device)
    last = torch.where(keep, pos, -1).amax(0, keepdim=True).clamp_min(0)
    any_kept = keep.any(0, keepdim=True)
    rows = rows.to(dst.dtype)
    tgt_l = torch.where(any_kept, tgt.gather(0, last), 0)
    row_l = torch.where(any_kept[:, None], rows.index_select(0, last),
                        dst[:1])
    dst.index_put_((torch.where(keep, tgt, tgt_l),),
                   torch.where(keep[:, None], rows, row_l))
    return dst


def gather_rows_dequant_ref(cache: torch.Tensor, scales: torch.Tensor,
                            ids: torch.Tensor,
                            out_dtype=torch.bfloat16) -> torch.Tensor:
    """cache [S, D] int8/fp8, scales [S, 1] f16, ids [...] -> rows
    [..., D] ``out_dtype``: ``float(q) * float(s)`` of row ``clip(ids)``,
    zero rows where ``ids < 0``."""
    safe = ids.clamp(0, cache.shape[0] - 1)
    rows = dequantize_rows(cache[safe], scales[safe], out_dtype)
    return torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))


def gather_pages_ref(cache: torch.Tensor, block_ids: torch.Tensor,
                     block_rows: int) -> torch.Tensor:
    """cache [L, S, D], block_ids [L, NB] -> [L, NB*block_rows, D]: whole
    pages of ``block_rows`` rows, page ids clipped to the pool."""
    Lh, S, D = cache.shape
    pages = cache.reshape(Lh, S // block_rows, block_rows, D)
    safe = block_ids.clamp(0, S // block_rows - 1)
    out = pages[torch.arange(Lh)[:, None], safe]          # [L, NB, R, D]
    return out.reshape(Lh, -1, D)


def put_pages_ref(dst: torch.Tensor, dst_ids: torch.Tensor,
                  src: torch.Tensor, block_rows: int) -> torch.Tensor:
    """In place: page ``i`` of ``src [L, NB*block_rows, D]`` -> page
    ``dst_ids[l, i]`` of ``dst [L, S, D]``; ids outside ``[0, S /
    block_rows)`` are dropped.  Returns ``dst``."""
    Lh, S, D = dst.shape
    npages = S // block_rows
    pages = dst.view(Lh, npages, block_rows, D)
    srcp = src.reshape(Lh, -1, block_rows, D)
    keep = (dst_ids >= 0) & (dst_ids < npages)                 # [L, NB]
    li, pi = keep.nonzero(as_tuple=True)
    pages[li, dst_ids[li, pi]] = srcp[li, pi].to(dst.dtype)
    return dst


def gather_pages_dequant_ref(cache: torch.Tensor, scales: torch.Tensor,
                             block_ids: torch.Tensor, block_rows: int,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`gather_pages_ref` of a quantized tier: cache [L, S, D]
    int8/fp8, scales [L, S, 1] f16 -> ``out_dtype`` pages."""
    return dequantize_rows(gather_pages_ref(cache, block_ids, block_rows),
                           gather_pages_ref(scales, block_ids, block_rows),
                           out_dtype)
