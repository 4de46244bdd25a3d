"""The monolithic decoder stack (counterpart of the ``lm`` kind of
``repro.models.transformer`` for the MLA + DSA arch): the train, prefill
and decode modes of ``forward``, with the whole latent cache in device
memory.  This is the baseline ESS is measured against and its oracle.

Cache convention, a dict::

    {"lens": [B] int64,                  # tokens already in the cache
     "mla":  MLACache of [L,B,S,...]}    # latent rows, indexer keys

The layers run unrolled (the reference scans each homogeneous group):
the leading dense layers, then the MoE layers, each given its view of the
stacked cache.  A decode step writes the new rows into those views in
place and returns ``lens + Q``; nothing in it waits for the card, so it
can be captured as a CUDA graph (:func:`repro_torch.serving.engine
.generic_decode` keeps ``lens`` in place too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How ``cfg.num_layers`` decompose into homogeneous layer groups."""
    kind: str                      # lm (the only kind ported)
    dense_layers: int = 0          # leading dense layers (deepseek)
    main_layers: int = 0           # the main (MoE) group


def stack_plan(cfg: ArchConfig) -> StackPlan:
    dense = cfg.moe.first_dense_layers if cfg.moe else 0
    return StackPlan("lm", dense_layers=dense,
                     main_layers=cfg.num_layers - dense)


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The decode cache, zeros, on ``device`` (the card by default)."""
    if cfg.mla is None or cfg.dsa is None:
        raise B._no_indexer()
    dev = resolve_device(device)
    Lh = cfg.num_layers
    return {"lens": torch.zeros((batch,), dtype=torch.int64, device=dev),
            "mla": B.MLACache(
                torch.zeros((Lh, batch, max_seq, cfg.mla.latent_dim),
                            dtype=dtype, device=dev),
                torch.zeros((Lh, batch, max_seq, cfg.dsa.index_dim),
                            dtype=dtype, device=dev))}


def pad_caches(caches: dict, max_seq: int) -> dict:
    """A prefill's caches (``S`` positions) with zero room up to
    ``max_seq`` for decode steps (the reference's callers ``jnp.pad``)."""
    def pad(a):
        out = a.new_zeros(a.shape[:2] + (max_seq,) + a.shape[3:])
        out[:, :, :a.shape[2]] = a
        return out
    return {**caches, "mla": B.MLACache(*(pad(a) for a in caches["mla"]))}


class ForwardOut(NamedTuple):
    logits: torch.Tensor | None
    hidden: torch.Tensor
    caches: dict | None
    aux: dict


def layer_params(params: dict, cfg: ArchConfig, layer: int):
    """(parameter views of one layer of the stack, is_moe)."""
    nd = stack_plan(cfg).dense_layers

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    if layer < nd:
        return pick(params["dense_layers"], layer), False
    return pick(params["layers"], layer - nd), cfg.moe is not None


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
            positions: torch.Tensor, *, mode: str = "train",
            caches: dict | None = None, want_logits: bool = True,
            use_kernel: bool | None = None) -> ForwardOut:
    """Run the stack on token ids ``inputs [B,S]``.

    * ``"train"``: dense masked attention, no caches; ``aux`` holds the MoE
      layers' mean load-balance loss and dropped fraction (``moe_lb``,
      ``moe_dropped``; zeros in the other modes, where the port does not
      compute them).
    * ``"prefill"``: returns new caches of ``S`` positions, ``lens = S``
      (:func:`pad_caches` makes room to decode).
    * ``"decode"``: appends the Q tokens at ``caches["lens"]`` in place and
      returns the caches with ``lens + Q``.

    ``use_kernel`` picks the kernel route of prefill and decode (default:
    on CUDA tensors) or the plain version.  Logits are fp32."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    x = L.embed(params["embed"], inputs).to(cfg.param_dtype)
    lens = caches["lens"] if caches is not None else None
    train = mode == "train"
    lat, ik, mas = [], [], []
    for layer in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, layer)
        csl = None
        if mode == "decode":
            full = caches["mla"]
            csl = B.MLACache(full.latent[layer], full.ikeys[layer])
        x, nc, ma = B.mla_block(lp, cfg, x, positions, mode=mode, cache=csl,
                                lens=lens, moe=is_moe, train=train,
                                use_kernel=use_kernel)
        if mode == "prefill":
            lat.append(nc.latent)
            ik.append(nc.ikeys)
        if ma is not None:
            mas.append(ma)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux: dict[str, Any] = {"moe_lb": zero, "moe_dropped": zero}
    if mas:
        aux["moe_lb"] = torch.stack([a.load_balance_loss
                                     for a in mas]).mean()
        aux["moe_dropped"] = torch.stack([a.dropped_fraction
                                          for a in mas]).mean()

    new_caches = None
    Q = inputs.shape[1]
    if mode == "decode":
        new_caches = {**caches, "lens": lens + Q}
    elif mode == "prefill":
        new_caches = {**(caches or {}),
                      "mla": B.MLACache(torch.stack(lat), torch.stack(ik)),
                      "lens": torch.full((x.shape[0],), Q, dtype=torch.int64,
                                         device=x.device)}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params.get("unembed", params["embed"]), x) \
        if want_logits else None
    return ForwardOut(logits, x, new_caches, aux)
