"""Step factories (the port's counterpart of ``repro.launch.steps``): the
train step (loss, gradients, AdamW), the prefill step and the decode step
(the ESS-enabled DSA architecture through the offload-centric engine).

Gradients come from ``torch.autograd.grad`` over every float leaf, with
zeros for the leaves the loss does not reach (the MTP head, which train
mode does not run; V3.2's indexer, behind the boolean DSA mask), as
``jax.value_and_grad`` gives them, so AdamW decays those leaves and steps
their moments exactly as the reference does.

The dry-run half builds every cell's abstract arguments
(:func:`input_specs`, :func:`abstract_caches`, :func:`abstract_state`):
``meta`` tensors, DTensors on ``meta`` under the active sharding context
(:mod:`repro_torch.distributed.sharding`), so nothing is allocated;
:func:`make_step` picks the cell's step (train steps accumulate over
:func:`auto_accum` microbatches).  Token ids, positions and ``lens`` are
int64, the dtypes the port's steps take (the reference's are int32).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.cache import latent_cache as LC
from repro_torch.configs.base import ArchConfig, ShapeCell, ess_enabled
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.params import abstract_params, model_def
from repro_torch.serving import engine as E
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update)
from repro_torch.training.tree import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# Abstract inputs (the dry run)
# ---------------------------------------------------------------------------

def _dev(shape, dtype, *axes) -> torch.Tensor:
    ctx = shd.current()
    if ctx is None or ctx.mesh is None:
        return shd.abstract(shape, dtype)
    return shd.abstract(shape, dtype, ctx.sharding_for(tuple(shape), axes))


def seq_axis_name(cell: ShapeCell) -> str | None:
    """long_500k (batch 1) shards the *sequence* over the data axis (the
    rules' ``seq_data``; :func:`abstract_caches` reads it from B)."""
    return "seq" if cell.global_batch == 1 else None


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, Any]:
    """Abstract inputs of the cell's step (its batch dict)."""
    B, S = cell.global_batch, cell.seq_len
    bx = "batch" if B > 1 else None
    i64, bf16 = torch.int64, torch.bfloat16
    embeds = cfg.embedding_inputs and cfg.family != "audio"
    if cell.kind in ("train", "prefill"):
        sx = None if cell.kind == "train" else "seq"
        specs: dict[str, Any] = {}
        if embeds:
            specs["inputs"] = _dev((B, S, cfg.d_model), bf16, bx, sx, None)
        else:
            specs["inputs"] = _dev((B, S), i64, bx, sx)
        if cell.kind == "train":
            specs["labels"] = _dev((B, S), i64, bx, None)
        specs["positions"] = _dev((B, S), i64, bx, sx)
        if cfg.family == "audio":
            specs["enc_inputs"] = _dev((B, cfg.encdec.encoder_seq,
                                        cfg.d_model), bf16, bx, None, None)
        if cfg.mrope_sections is not None:
            specs["mrope_positions"] = _dev((B, S, 3), i64, bx, None, None)
        return specs
    # decode: one new token against a seq_len cache
    specs = {"caches": abstract_caches(cfg, B, S)}
    if embeds:
        specs["inputs"] = _dev((B, 1, cfg.d_model), bf16, bx, None, None)
    else:
        specs["inputs"] = _dev((B, 1), i64, bx, None)
    specs["positions"] = _dev((B, 1), i64, bx, None)
    return specs


def abstract_caches(cfg: ArchConfig, B: int, S: int) -> Any:
    """The decode cache tree as abstract leaves (:func:`~repro_torch
    .models.transformer.cache_spec` on ``meta``), sharded under a context:

    * batch over the data dimensions (``pod``, ``data``) when B > 1;
    * KV heads over ``model`` when they divide it, else the cache's
      *sequence* over ``model`` (flash-decoding style);
    * B == 1 (long_500k): the sequence takes the data dimensions too;
    * MLA's latent / indexer keys are head-shared: always sequence over
      ``model``; with ESS the latent lives in the host tier instead
      (:func:`~repro_torch.cache.latent_cache.abstract_ess_caches`)."""
    if ess_enabled(cfg):
        return LC.abstract_ess_caches(cfg, B, S)
    concrete = T.cache_spec(cfg, B, S, device="meta")
    ctx = shd.current()
    if ctx is None or ctx.mesh is None:
        return tree_map(lambda x: shd.abstract(x.shape, x.dtype), concrete)
    names = set(ctx.mesh.mesh_dim_names)
    sizes = shd.mesh_sizes(ctx.mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    batch_entry = data_axes if B > 1 else None
    seq_data = data_axes if B == 1 else ()

    def seq_entry(extra_model: bool):
        ax = tuple(seq_data) + ((model,) if extra_model and model else ())
        if not ax:
            return None
        return ax if len(ax) > 1 else ax[0]

    def annotate(x):
        return shd.abstract(x.shape, x.dtype, shd.NamedSharding(
            ctx.mesh, shd.prune_spec(cache_spec_axes(x), tuple(x.shape),
                                     ctx.mesh)))

    def cache_spec_axes(x):
        nd, shape = x.dim(), tuple(x.shape)
        if nd == 1:                                     # lens
            return (batch_entry,)
        if nd == 5:
            if shape[2] == S:                           # kv cache
                kv_ok = model and shape[3] % sizes[model] == 0
                return (None, batch_entry, seq_entry(not kv_ok),
                        model if kv_ok else None, None)
            if cfg.encdec is not None and shape[2] == cfg.encdec.encoder_seq:
                kv_ok = model and shape[3] % sizes[model] == 0
                return (None, batch_entry, None,
                        model if kv_ok else None, None)
            h_ok = model and shape[2] % sizes[model] == 0  # ssm [L,B,H,P,N]
            return (None, batch_entry, model if h_ok else None, None, None)
        if nd == 4:
            if shape[2] == S:                           # latent/ikeys
                return (None, batch_entry, seq_entry(True), None)
            c_ok = model and shape[3] % sizes[model] == 0  # conv [L,B,W,C]
            return (None, batch_entry, None, model if c_ok else None)
        if nd == 3:
            return (None, batch_entry, None)
        return (None,) * nd

    return tree_map(annotate, concrete)


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
    if ess_enabled(cfg):
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


def dp_degree() -> int:
    """Product of the mesh-dimension sizes the ``batch`` logical axis
    maps to (1 outside a context)."""
    return shd.logical_axis_size("batch")


MICRO_SEQS = 4   # target sequences per device per microbatch


def auto_accum(cell: ShapeCell) -> int:
    b_loc = max(1, cell.global_batch // dp_degree())
    return int(min(8, max(1, b_loc // MICRO_SEQS)))


def make_step(cfg: ArchConfig, cell: ShapeCell) -> Callable:
    """The cell's step: train (accumulating over :func:`auto_accum`
    microbatches, updating in place as the reference's donated step),
    prefill or decode."""
    if cell.kind == "train":
        return make_train_step(cfg, accum_steps=auto_accum(cell),
                               donate=True)
    if cell.kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def abstract_state(cfg: ArchConfig, cell: ShapeCell):
    """Abstract ``(params[, opt_state])`` under the active context: the
    optimizer's moments fp32 with the parameters' shardings, its step an
    int32 scalar."""
    ctx = shd.current()
    mesh = ctx.mesh if ctx else None
    params = abstract_params(model_def(cfg), mesh, ctx.rules if ctx else {})
    if cell.kind != "train":
        return params, None
    moments = [tree_map(lambda p: shd.abstract_like(p, torch.float32),
                        params) for _ in range(2)]
    opt = OptState(m=moments[0], v=moments[1], step=_dev((), torch.int32))
    return params, opt

