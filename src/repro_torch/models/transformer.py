"""The monolithic decoder stack (counterpart of the ``lm`` kind of
``repro.models.transformer``): the train, prefill and decode modes of
``forward`` for the GQA architectures (dense, MoE, gemma's local / global
patterns, qwen2-vl's M-RoPE over embedding inputs) and the MLA ones
(DeepSeek-V3's dense MLA, V3.2's DSA), with the whole cache in device
memory.  This is the baseline ESS is measured against and its oracle.

Cache convention, a dict::

    {"lens": [B] int64,                  # tokens already in the cache
     "kv":   GQACache of [L,B,S,KV,hd],  # GQA archs
     "mla":  MLACache of [L,B,S,...]}    # MLA archs: latent rows, indexer
                                         # keys ([.., 1] zeros without DSA)

The layers run unrolled (the reference scans each homogeneous group):
the leading dense layers, then the main group, each given its view of the
stacked cache.  A decode step writes the new rows into those views in
place and returns ``lens + Q``; nothing in it waits for the card, so it
can be captured as a CUDA graph (:func:`repro_torch.serving.engine
.generic_decode` keeps ``lens`` in place too).  The SSM, hybrid and
encoder-decoder stacks are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

# a window this wide is global (the reference's traced override)
GLOBAL_WINDOW = 2 ** 30


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How ``cfg.num_layers`` decompose into homogeneous layer groups."""
    kind: str                      # lm (the only kind ported)
    dense_layers: int = 0          # leading dense layers (deepseek)
    main_layers: int = 0           # the main group (MoE where configured)


def stack_plan(cfg: ArchConfig) -> StackPlan:
    if cfg.family in ("ssm", "hybrid", "encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} stack is not ported (ROADMAP "
            f"Queue 1)")
    dense = cfg.moe.first_dense_layers if cfg.moe else 0
    return StackPlan("lm", dense_layers=dense,
                     main_layers=cfg.num_layers - dense)


def _cache_key(cfg: ArchConfig) -> str:
    return "mla" if cfg.attn_kind == "mla" else "kv"


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The decode cache, zeros, on ``device`` (the card by default)."""
    stack_plan(cfg)
    dev = resolve_device(device)
    Lh = cfg.num_layers

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    c = {"lens": torch.zeros((batch,), dtype=torch.int64, device=dev)}
    if cfg.attn_kind == "mla":
        Di = cfg.dsa.index_dim if cfg.dsa else 1
        c["mla"] = B.MLACache(z(Lh, batch, max_seq, cfg.mla.latent_dim),
                              z(Lh, batch, max_seq, Di))
    else:
        kv = (Lh, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        c["kv"] = B.GQACache(z(*kv), z(*kv))
    return c


def pad_caches(caches: dict, max_seq: int) -> dict:
    """A prefill's caches (``S`` positions) with zero room up to
    ``max_seq`` for decode steps (the reference's callers ``jnp.pad``)."""
    def pad(a):
        out = a.new_zeros(a.shape[:2] + (max_seq,) + a.shape[3:])
        out[:, :, :a.shape[2]] = a
        return out
    out = dict(caches)
    for key, kind in (("mla", B.MLACache), ("kv", B.GQACache)):
        if key in caches:
            out[key] = kind(*(pad(a) for a in caches[key]))
    return out


def layer_meta(cfg: ArchConfig, n: int, offset: int = 0):
    """Per layer of ``[offset, offset + n)``: (is_local, rope theta);
    gemma3's local layers take ``local_rope_theta``."""
    kinds = [cfg.pattern_at(offset + i) for i in range(n)]
    is_local = [1.0 if k == "local" else 0.0 for k in kinds]
    theta = [(cfg.local_rope_theta or cfg.rope_theta) if k == "local"
             else cfg.rope_theta for k in kinds]
    return is_local, theta


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


def _embed_in(params: dict, cfg: ArchConfig, inputs: torch.Tensor
              ) -> torch.Tensor:
    """Token ids [B,S] through ``embed``, or embeddings [B,S,d] as given
    (``embedding_inputs``); gemma scales by sqrt(d_model) in the input's
    dtype (the reference's weak-typed product)."""
    x = inputs if cfg.embedding_inputs else L.embed(params["embed"], inputs)
    if cfg.scale_embeddings:
        x = x * L.const(math.sqrt(cfg.d_model), x.dtype)
    return x.to(cfg.param_dtype)


def _unembed(params: dict, cfg: ArchConfig, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["unembed"] if "unembed" in params else params["embed"]
    return L.unembed(w, x, cap=cfg.logit_softcap)


def _cache_positions(csl: B.GQACache | None) -> torch.Tensor | None:
    if csl is None:
        return None
    Bn, S = csl.k.shape[:2]
    return torch.arange(S, device=csl.k.device)[None, :].expand(Bn, S)


def _gqa_traced(lp, cfg, x, positions, mode, csl, lens, loc, theta,
                mrope_positions, moe):
    """gqa_block with the reference's per-layer rules: in a mixed local /
    global pattern each layer gets a window (``2**30``: global), a config
    with a window and no pattern is all local, and each layer its theta."""
    wov = None
    if cfg.layer_pattern is not None and cfg.sliding_window is not None:
        wov = cfg.sliding_window if loc > 0.5 else GLOBAL_WINDOW
    kind = "local" if (cfg.layer_pattern is None and cfg.sliding_window) \
        else "global"
    return B.gqa_block(lp, cfg, x, positions, mode=mode, kind=kind,
                       cache=csl, lens=lens,
                       cache_positions=_cache_positions(csl),
                       rope_theta=theta, mrope_positions=mrope_positions,
                       window_override=wov, moe=moe, train=mode == "train")


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
            positions: torch.Tensor, *, mode: str = "train",
            caches: dict | None = None,
            mrope_positions: torch.Tensor | None = None,
            want_logits: bool = True,
            use_kernel: bool | None = None) -> ForwardOut:
    """Run the stack on token ids ``inputs [B,S]`` (embeddings ``[B,S,d]``
    under ``embedding_inputs``); ``mrope_positions [B,S,3]`` for M-RoPE.

    * ``"train"``: dense masked attention, no caches; ``aux`` holds the MoE
      layers' mean load-balance loss and dropped fraction (``moe_lb``,
      ``moe_dropped``; zeros in the other modes, where the port does not
      compute them).
    * ``"prefill"``: returns new caches of ``S`` positions, ``lens = S``
      (:func:`pad_caches` makes room to decode).
    * ``"decode"``: appends the Q tokens at ``caches["lens"]`` in place and
      returns the caches with ``lens + Q``.

    ``use_kernel`` picks the kernel route of MLA's prefill and decode
    (default: on CUDA tensors) or the plain version; GQA attention is
    plain torch on every device (the reference has no kernel there).
    Logits are fp32."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    stack_plan(cfg)
    x = _embed_in(params, cfg, inputs)
    lens = caches["lens"] if caches is not None else None
    key = _cache_key(cfg)
    train = mode == "train"
    is_local, theta = layer_meta(cfg, cfg.num_layers)
    planes, mas = [], []
    for layer in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, layer)
        csl = None
        if mode == "decode":
            full = caches[key]
            csl = type(full)(*(a[layer] for a in full))
        if key == "mla":
            x, nc, ma = B.mla_block(lp, cfg, x, positions, mode=mode,
                                    cache=csl, lens=lens, moe=is_moe,
                                    train=train, use_kernel=use_kernel)
        else:
            x, nc, ma = _gqa_traced(lp, cfg, x, positions, mode, csl, lens,
                                    is_local[layer], theta[layer],
                                    mrope_positions, is_moe)
        if mode == "prefill":
            planes.append(nc)
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
        kind = type(planes[0])
        new_caches = {**(caches or {}),
                      key: kind(*(torch.stack(a) for a in zip(*planes))),
                      "lens": torch.full((x.shape[0],), Q, dtype=torch.int64,
                                         device=x.device)}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x) if want_logits else None
    return ForwardOut(logits, x, new_caches, aux)
