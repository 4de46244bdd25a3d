"""AdamW and its schedule (the port's own copy of
``repro.training.optimizer``).

Moments are fp32 whatever the parameters' dtype.  The schedule and the
bias corrections are fp32 tensors computed on the device from the step
counter (an int32 tensor), as the reference's jitted update computes
them, so the update waits for nothing on the host and a train step can be
captured later.  ``inplace=True`` (a train step's ``donate``, the
reference's ``donate_argnums``) writes the new parameters and moments
into the old tensors, one leaf at a time: the update then holds a few
temporaries of one leaf's size, not a second copy of the model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor        # int32, on the parameters' device


def init_opt_state(params: Any) -> OptState:
    """Zero fp32 moments beside every leaf, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps`` (fp32)."""
    s = step.float()
    warm = cfg.lr * torch.clamp((s + 1) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return warm * torch.where(s < cfg.warmup_steps, 1.0, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm of every leaf together, fp32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves(tree)])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """``(grads scaled to a global norm of at most max_norm, fp32; the
    norm before)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
                 *, inplace: bool = False) -> tuple[Any, OptState, dict]:
    """One AdamW step with global-norm clipping: ``(params, state,
    {"grad_norm", "lr"})``.  Every leaf is updated, those with a zero
    gradient included (decayed, their moments stepped), as the reference
    updates them.  ``inplace`` writes into ``params`` and ``state``'s
    tensors and returns them."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    s = step.float()
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)

    def upd(p, g, m, v):
        # the reference's arithmetic, op for op; each temporary is one
        # leaf's size and goes as soon as it is used
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        del g
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p2 = (p.float() - lr * delta).to(p.dtype)
        del delta
        if not inplace:
            return p2, m2, v2
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        return p, m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    if inplace:
        state.step.copy_(step)
        new_state = state
    else:
        new_state = OptState(unflatten(state.m, [o[1] for o in out]),
                             unflatten(state.v, [o[2] for o in out]), step)
    return unflatten(params, [o[0] for o in out]), new_state, \
        {"grad_norm": gnorm, "lr": lr}
