"""Step factories (the port's counterpart of ``repro.launch.steps``): the
train step (loss, gradients, AdamW), the prefill step and the decode step
(the ESS-enabled DSA architecture through the offload-centric engine).

Gradients come from ``torch.autograd.grad`` over every float leaf, with
zeros for the leaves the loss does not reach (the MTP head, which train
mode does not run; V3.2's indexer, behind the boolean DSA mask), as
``jax.value_and_grad`` gives them, so AdamW decays those leaves and steps
their moments exactly as the reference does.

The reference's dry-run half (``input_specs``, ``abstract_caches``,
``abstract_state``, ``dp_degree``, ``auto_accum``, ``make_step``) rests on
its sharding context and is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.tree import leaves, unflatten


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy, fp32, mean over tokens."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold)


def train_loss(params: dict, cfg: ArchConfig, batch: dict
               ) -> tuple[torch.Tensor, dict]:
    """``(loss + 0.01 * moe_lb, aux)`` of ``forward(mode="train")`` on a
    batch ``{"inputs", "labels", "positions"[, "mrope_positions",
    "enc_inputs"]}``."""
    out = T.forward(params, cfg, batch["inputs"], batch["positions"],
                    mode="train",
                    mrope_positions=batch.get("mrope_positions"),
                    enc_inputs=batch.get("enc_inputs"))
    loss = lm_loss(out.logits, batch["labels"])
    return loss + 0.01 * out.aux["moe_lb"], out.aux


def _micro_grads(params, cfg, batch):
    req = [t.detach().requires_grad_() for t in leaves(params)]
    with torch.enable_grad():
        loss, _ = train_loss(unflatten(params, req), cfg, batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def loss_and_grads(params: dict, cfg: ArchConfig, batch: dict,
                   accum_steps: int = 1) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)``: the gradient of :func:`train_loss` for every
    leaf of ``params`` (all float), in the leaves' dtype, zeros where the
    loss does not reach; the loss detached.

    With ``accum_steps > 1`` the batch splits into that many microbatches
    along its first dim: the gradients are summed in the leaves' dtype and
    the losses in fp32, both then divided by ``accum_steps`` (the
    reference's scan)."""
    n = next(iter(batch.values())).shape[0] // accum_steps
    loss, acc = None, None
    for i in range(accum_steps):
        mb = batch if accum_steps == 1 else \
            {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        li, gi = _micro_grads(params, cfg, mb)
        if acc is None:
            loss, acc = li, gi
        else:
            loss = loss + li
            for a, g in zip(acc, gi):
                a.add_(g)
        del gi
    if accum_steps > 1:
        for a in acc:
            a.div_(accum_steps)
        loss = loss / accum_steps
    return loss, unflatten(params, acc)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                    accum_steps: int = 1, *, donate: bool = False
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``: :func:`loss_and_grads` over
    ``accum_steps`` microbatches, then
    :func:`~repro_torch.training.optimizer.adamw_update`.  ``donate`` (the
    reference's ``donate_argnums``) updates the parameters and the
    optimizer state in place (``adamw_update``'s ``inplace``); without it
    the step leaves its arguments as they were.  Nothing in it waits for
    the card."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch, accum_steps)
        params2, opt_state2, om = adamw_update(opt_cfg, params, grads,
                                               opt_state, inplace=donate)
        return params2, opt_state2, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        out = T.forward(params, cfg, batch["inputs"], batch["positions"],
                        mode="prefill",
                        mrope_positions=batch.get("mrope_positions"),
                        enc_inputs=batch.get("enc_inputs"))
        return out.logits, out.caches
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """One new token against a cache: the ESS-enabled architecture
    (DeepSeek-V3.2's DSA; the port's configs carry no ``enabled`` switch,
    and the reference enables ESS on exactly those) through
    :func:`~repro_torch.serving.engine.ess_decode` (its ``ESSCaches``),
    the others through ``forward(mode="decode")``."""
    if cfg.attn_kind == "mla" and cfg.dsa is not None:
        def decode_step(params, batch):
            out = E.ess_decode(params, cfg, batch["inputs"],
                               batch["positions"], batch["caches"],
                               slot_mask=None)
            return out.logits, out.caches
        return decode_step

    def decode_step(params, batch):
        out = T.forward(params, cfg, batch["inputs"], batch["positions"],
                        mode="decode", caches=batch["caches"])
        return out.logits, out.caches
    return decode_step
