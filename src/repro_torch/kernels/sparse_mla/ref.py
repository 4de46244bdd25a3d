"""Plain PyTorch version of the sparse-MLA partial kernel (fp32 throughout,
as the Pallas kernel and its oracle ``repro.kernels.sparse_mla.ref``)."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def sparse_mla_partial_ref(q: torch.Tensor, rows: torch.Tensor,
                           valid: torch.Tensor, scale: float, rank: int):
    """q [B,Q,H,D], rows [B,Q,K,D], valid [B,Q,K] ->
    (o [B,Q,H,rank], m [B,Q,H], l [B,Q,H]) unnormalized fp32 partials."""
    s = torch.einsum("bqhd,bqkd->bqhk", q.float(), rows.float()) * scale
    v = valid[:, :, None, :]
    s = torch.where(v, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(v, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bqhk,bqkv->bqhv", p, rows[..., :rank].float())
    return o, m, l


def merge_splits_ref(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """Combine partials of disjoint row splits, stacked on dim 0:
    o [S,...,rank], m / l [S,...] -> (o, m, l) of the union.  An
    all-invalid split (m = -2e38, l = 0, o = 0) adds nothing; if every
    split is, the result is that sentinel partial."""
    mx = m.amax(dim=0)
    w = torch.exp(m - mx)
    return (o * w[..., None]).sum(dim=0), mx, (l * w).sum(dim=0)
