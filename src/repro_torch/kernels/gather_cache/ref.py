"""Plain PyTorch versions of the row gather / scatter kernels."""

from __future__ import annotations

import torch


def gather_rows_ref(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """cache [S, D], ids [...] -> rows [..., D]: ``cache[clip(ids)]`` with
    zero rows where ``ids < 0``."""
    safe = ids.clamp(0, cache.shape[0] - 1)
    rows = cache[safe]
    return torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))


def scatter_rows_ref(dst: torch.Tensor, tgt: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """In place: ``dst[tgt[i]] = rows[i]`` where ``0 <= tgt[i] < len(dst)``;
    the other rows are dropped.  dst [N, D], tgt [M], rows [M, D]."""
    keep = (tgt >= 0) & (tgt < dst.shape[0])
    dst[tgt[keep]] = rows[keep].to(dst.dtype)
    return dst
