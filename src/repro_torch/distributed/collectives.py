"""Distributed attention helpers: the exact cross-shard flash-decode merge
(counterpart of ``repro.distributed.collectives``).

For long contexts the cache's sequence dim is sharded over one mesh
dimension; each rank computes a flash partial over its own chunk and the
merge is an exact renormalization across ranks, the distributed analogue
of ESS's Attn0 / Attn1 merge: one ``all_reduce`` MAX of the row maxima,
then SUMs of the rescaled outputs and denominators over the process group
of that mesh dimension.  The partial is plain torch, as the reference's
is (it runs outside any Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -2.0e38


def local_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, scale: float):
    """One shard's flash statistics.  q [B,H,D], k/v [B,Sl,D], valid
    [B,Sl].  Returns (o [B,H,Dv], m [B,H], l [B,H]) unnormalized, fp32."""
    s = torch.einsum("bhd,bsd->bhs", q.float(), k.float()) * scale
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid[:, None, :], torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhs,bsd->bhd", p, v.float())
    return o, m, l


def merge_across(group, o: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                 ) -> torch.Tensor:
    """Exact renormalized merge of the ranks' partials over ``group``:
    every rank returns the merged ``o / l``."""
    m_max = m.clone()
    dist.all_reduce(m_max, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_max)
    o_sum = o * corr[..., None]
    l_sum = l * corr
    dist.all_reduce(o_sum, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(l_sum, op=dist.ReduceOp.SUM, group=group)
    return o_sum / l_sum.clamp_min(1e-30)[..., None]


def seq_shard(t: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """This rank's block of ``t``'s dim 1 over mesh dimension ``dim``: a
    DTensor is redistributed to ``Shard(1)`` there (replicated elsewhere)
    and its local tensor taken; a plain tensor holds the whole value on
    every rank and is chunked (``shard_map``'s ``in_specs``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    i = list(mesh.mesh_dim_names).index(dim)
    if isinstance(t, DTensor):
        pl = [Replicate()] * mesh.ndim
        pl[i] = Shard(1)
        return t.redistribute(mesh, pl).to_local()
    n = mesh.size(i)
    return t.tensor_split(n, dim=1)[mesh.get_local_rank(dim)]


def sharded_flash_decode(mesh, dim: str, q, k_sharded, v_sharded, valid,
                         scale: float) -> torch.Tensor:
    """Decode attention with the sequence sharded over mesh dimension
    ``dim``: q [B,H,D] replicated, k / v [B,S,D] and valid [B,S] sharded
    on S (DTensors, or whole tensors each rank takes its block of).
    Returns the merged [B,H,Dv] fp32, the same on every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        q = q.full_tensor()
    o, m, l = local_partial(q, seq_shard(k_sharded, mesh, dim),
                            seq_shard(v_sharded, mesh, dim),
                            seq_shard(valid, mesh, dim), scale)
    return merge_across(mesh.get_group(dim), o, m, l)
