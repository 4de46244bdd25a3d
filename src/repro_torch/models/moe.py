"""Mixture-of-Experts with fixed-capacity dispatch (counterpart of
``repro.models.moe``).

DeepSeek sigmoid routing with the aux-loss-free selection bias, top-k
combine weights from the unbiased gates, routed scaling, capacity
``ceil(T*K/E*cf)`` capped at T with slots assigned by a token-major cumsum
(the reference's exact drop rule), and the shared expert.  The dispatch is
an index scatter into ``[E, C, d]`` instead of the reference's one-hot
einsums: the same rows land in the same slots.  ``train=True`` also
returns the router statistics (:class:`MoEAux`); the serve path, which
calls :func:`moe_apply` every round, leaves them out.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.mla import topk_desc


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_entropy: torch.Tensor
    dropped_fraction: torch.Tensor


def router_probs(p: dict, cfg: ArchConfig, x2: torch.Tensor):
    """x2 [T,d] -> (selection scores [T,E], combine-weight base [T,E])."""
    logits = x2.float() @ p["router"]
    if cfg.moe.router_bias:
        gates = torch.sigmoid(logits)
        return gates + p["router_bias"][None, :], gates
    probs = torch.softmax(logits, dim=-1)
    return probs, probs


# elements of one [E, C, max(d, d_expert)] dispatch buffer above which a
# MoE whose capacity cannot bind runs its tokens in chunks
DISPATCH_ELEMS = 1 << 30


def moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              train: bool = False):
    """x [B,S,d] -> y [B,S,d], or ``(y, MoEAux)`` when ``train``.

    Where the capacity cannot bind (``top_k * capacity_factor >= E``: the
    capacity is every token, none drops) each token's output is its own,
    and a batch whose ``[E, T, width]`` buffers would pass
    ``DISPATCH_ELEMS`` runs in chunks of tokens: the same function, in
    memory a prefill can hold (DeepSeek-V3's 256 experts at 32K tokens
    would need 120 GB)."""
    mo = cfg.moe
    B, S, d = x.shape
    E, width = mo.num_experts, max(d, mo.d_expert)
    if not train and mo.top_k * mo.capacity_factor >= E \
            and E * B * S * width > DISPATCH_ELEMS:
        n = max(1, DISPATCH_ELEMS // (E * width))
        x1 = x.reshape(1, B * S, d)
        return torch.cat([_moe_apply(p, cfg, x1[:, i:i + n])
                          for i in range(0, B * S, n)], 1).view(B, S, d)
    return _moe_apply(p, cfg, x, train=train)


def _moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
               train: bool = False):
    mo = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, mo.num_experts, mo.top_k
    x2 = L.flat2d(x, 2)                                       # [T,d]

    sel, gates = router_probs(p, cfg, x2)
    top_ids = topk_desc(sel, K)                              # [T,K]
    w = gates.gather(1, top_ids)                             # [T,K]
    if mo.norm_topk:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-20)
    w = w * mo.routed_scale

    capacity = min(max(1, int(math.ceil(T * K / E * mo.capacity_factor))), T)
    # position of each (token, choice) inside its expert: token-major cumsum
    flat = (top_ids.reshape(T * K, 1) == torch.arange(
        E, device=x.device)).long()                          # [T*K,E]
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1)           # [T*K]
    keep = pos < capacity
    w = torch.where(keep.view(T, K), w, torch.zeros_like(w))

    # scatter kept rows into [E*C (+1 drop row), d]
    slot = torch.where(keep, top_ids.reshape(-1) * capacity + pos,
                       E * capacity)
    xin = x2.new_zeros((E * capacity + 1, d))
    xin[slot] = x2[:, None].expand(T, K, d).reshape(T * K, d)
    xin = shard(xin[:E * capacity].view(E, capacity, d), "experts", None,
                None)
    h = L.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    h = shard(h, "experts", None, "ff")
    out_e = torch.bmm(h, p["w_down"]).view(E * capacity, d)
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))])      # drop row -> 0
    y = (out_e[slot].view(T, K, d).float() * w[..., None]).sum(1)
    y = y.to(x.dtype).view(B, S, d)
    if mo.num_shared:
        y = y + L.mlp(p["shared"], x, cfg.act)
    if not train:
        return y
    return y, _aux(sel, gates, top_ids, keep, E)


def _aux(sel, gates, top_ids, keep, E: int) -> MoEAux:
    """The reference's switch-style statistics: load balance
    ``mean(me * ce)`` (routed fraction x mean normalized selection score,
    each times E), the gates' entropy and the dropped share of the T*K
    assignments."""
    # the experts' counts as a one-hot sum (the reference's one-hot mean):
    # DTensor has no strategy for ``bincount``; the counts are exact
    experts = torch.arange(E, device=top_ids.device)
    me = (top_ids.reshape(-1, 1) == experts).float().sum(0) \
        / top_ids.numel() * E
    ce = (sel / sel.sum(-1, keepdim=True).clamp_min(1e-20)).mean(0) * E
    ent = -torch.where(gates > 0, gates * torch.log(gates + 1e-20),
                       torch.zeros_like(gates)).sum(-1).mean()
    dropped = 1.0 - keep.float().sum() / keep.numel()
    return MoEAux((me * ce).mean(), ent, dropped)
