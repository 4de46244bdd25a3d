"""The model stacks (counterpart of ``repro.models.transformer``): the
train, prefill and decode modes of ``forward`` for

* the ``lm`` kind: the GQA architectures (dense, MoE, gemma's local /
  global patterns, qwen2-vl's M-RoPE over embedding inputs) and the MLA
  ones (DeepSeek-V3's dense MLA, V3.2's DSA);
* the ``ssm`` kind: a Mamba2 stack (mamba2-780m);
* the ``hybrid`` kind: Mamba2 layers in groups of ``attn_every``, each
  group followed by one of ``num_shared_attn`` shared attention blocks in
  turn, the remainder layers after the groups (zamba2-7b);
* the ``encdec`` kind: a dense unmasked encoder over precomputed frame
  embeddings (the stubbed front end), then a decoder with cross-attention
  over per-layer encoder k / v (whisper-large-v3),

with the whole cache in device memory.  This is the baseline ESS is
measured against and its oracle.

Cache convention, a dict::

    {"lens": [B] int64,                  # tokens already in the cache
     "kv":   GQACache of [L,B,S,KV,hd],  # GQA archs, the decoder's
     "mla":  MLACache of [L,B,S,...],    # MLA archs: latent rows, indexer
                                         # keys ([.., 1] zeros without DSA)
     "ssm":  SSMState of [L,B,...],      # ssm / hybrid archs
     "shared_kv": GQACache of [napp,B,S,KV,hd],  # hybrid: one per group
     "enc_kv": GQACache of [L,B,Se,KV,hd]}       # encdec: cross k / v

The layers run unrolled (the reference scans each homogeneous group),
each given its view of the stacked cache.  A decode step writes the new
rows (and the SSM state) into those views in place and returns
``lens + Q``; nothing in it waits for the card, so it can be captured as
a CUDA graph (:func:`repro_torch.serving.engine.generic_decode` keeps
``lens`` in place too).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

# a window this wide is global (the reference's traced override)
GLOBAL_WINDOW = 2 ** 30


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How ``cfg.num_layers`` decompose into homogeneous layer groups."""
    kind: str                      # lm | ssm | hybrid | encdec
    dense_layers: int = 0          # leading dense layers (deepseek)
    main_layers: int = 0           # the main group (MoE where configured)
    hybrid_groups: int = 0         # zamba: full groups of attn_every
    hybrid_rem: int = 0            # zamba: SSM layers after the groups


def stack_plan(cfg: ArchConfig) -> StackPlan:
    if cfg.family in ("encdec", "audio"):
        return StackPlan("encdec", main_layers=cfg.num_layers)
    if cfg.family == "ssm":
        return StackPlan("ssm", main_layers=cfg.num_layers)
    if cfg.family == "hybrid":
        g = cfg.hybrid.attn_every
        return StackPlan("hybrid", hybrid_groups=cfg.num_layers // g,
                         hybrid_rem=cfg.num_layers % g)
    dense = cfg.moe.first_dense_layers if cfg.moe else 0
    return StackPlan("lm", dense_layers=dense,
                     main_layers=cfg.num_layers - dense)


def _cache_key(cfg: ArchConfig) -> str:
    return "mla" if cfg.attn_kind == "mla" else "kv"


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The decode cache, zeros, on ``device`` (the card by default): the
    attention planes in ``dtype``, the SSM state in fp32 (the reference's
    ``init_state``)."""
    plan = stack_plan(cfg)
    dev = resolve_device(device)
    Lh = cfg.num_layers

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n, s):
        shape = (n, batch, s, cfg.num_kv_heads, cfg.head_dim)
        return B.GQACache(z(*shape), z(*shape))
    c = {"lens": torch.zeros((batch,), dtype=torch.int64, device=dev)}
    if plan.kind in ("ssm", "hybrid"):
        c["ssm"] = SSM.SSMState(*(a.new_zeros((Lh,) + a.shape) for a in
                                  SSM.init_state(cfg, batch, device=dev)))
    if plan.kind == "hybrid":
        c["shared_kv"] = kv(plan.hybrid_groups, max_seq)
    elif plan.kind == "encdec":
        c["kv"] = kv(Lh, max_seq)
        c["enc_kv"] = kv(Lh, cfg.encdec.encoder_seq)
    elif plan.kind == "lm" and cfg.attn_kind == "mla":
        Di = cfg.dsa.index_dim if cfg.dsa else 1
        c["mla"] = B.MLACache(z(Lh, batch, max_seq, cfg.mla.latent_dim),
                              z(Lh, batch, max_seq, Di))
    elif plan.kind == "lm":
        c["kv"] = kv(Lh, max_seq)
    return c


def pad_caches(caches: dict, max_seq: int) -> dict:
    """A prefill's caches (``S`` positions) with zero room up to
    ``max_seq`` for decode steps (the reference's callers ``jnp.pad``):
    the self-attention planes; the encoder's k / v and the SSM state have
    no sequence axis to grow."""
    def pad(a):
        out = a.new_zeros(a.shape[:2] + (max_seq,) + a.shape[3:])
        out[:, :, :a.shape[2]] = a
        return out
    out = dict(caches)
    for key in ("mla", "kv", "shared_kv"):
        if key in caches:
            out[key] = type(caches[key])(*(pad(a) for a in caches[key]))
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    """``"dots"``: keep the outputs of the products without batch dims
    (``mm`` / ``addmm``: the projections, which run through
    :func:`~repro_torch.models.layers.proj` or ``@`` on a weight), and
    recompute everything else (batched products at any batch, attention's
    at batch 1 too, softmax, elementwise)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def maybe_remat(fn, cfg: ArchConfig, mode: str):
    """Activation checkpointing of a train-mode layer body, as the
    reference's ``maybe_remat`` (``cfg.remat``): ``"full"`` keeps the
    body's inputs alone and recomputes the rest in the backward,
    ``"dots"`` (the counterpart of ``dots_with_no_batch_dims_saveable``)
    also keeps the outputs of its products without batch dims
    (:func:`_dots_policy`), ``"none"`` keeps everything autograd saves.
    The values are the same under each.  Outside train mode, or with
    autograd off, the body runs as it is."""
    if mode != "train" or cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: none | full | dots")
    kw = {"context_fn": _DOTS_CONTEXT} if cfg.remat == "dots" else {}

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw, **kwargs)
    return run


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


def pick(tree: dict, i: int) -> dict:
    """Entry ``i`` of every leaf of a stacked parameter tree (views)."""
    return {k: pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_params(params: dict, cfg: ArchConfig, layer: int):
    """(parameter views of one layer of the ``lm`` stack, is_moe)."""
    nd = stack_plan(cfg).dense_layers
    if layer < nd:
        return pick(params["dense_layers"], layer), False
    return pick(params["layers"], layer - nd), cfg.moe is not None


def _layer_cache(full, i: int):
    """Layer ``i``'s views of a stacked cache (a NamedTuple of planes)."""
    return type(full)(*(a[i] for a in full))


def _stacked(planes: list):
    """Per-layer caches (NamedTuples of planes) -> one of stacked planes."""
    return type(planes[0])(*(torch.stack(a) for a in zip(*planes)))


def _embed_in(params: dict, cfg: ArchConfig, inputs: torch.Tensor
              ) -> torch.Tensor:
    """Token ids [B,S] through ``embed``, or embeddings [B,S,d] as given
    (``embedding_inputs``); gemma scales by sqrt(d_model) in the input's
    dtype (the reference's weak-typed product)."""
    x = inputs if cfg.embedding_inputs else L.embed(params["embed"], inputs)
    if cfg.scale_embeddings:
        x = x * L.const(math.sqrt(cfg.d_model), x.dtype)
    return shard(x.to(cfg.param_dtype), "batch", "seq_sp", "embed_act")


def _unembed(params: dict, cfg: ArchConfig, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["unembed"] if "unembed" in params else params["embed"]
    return shard(L.unembed(w, x, cap=cfg.logit_softcap),
                 "batch", "seq_sp", "vocab")


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
            enc_inputs: torch.Tensor | None = None,
            want_logits: bool = True,
            use_kernel: bool | None = None) -> ForwardOut:
    """Run the stack on token ids ``inputs [B,S]`` (embeddings ``[B,S,d]``
    under ``embedding_inputs``); ``mrope_positions [B,S,3]`` for M-RoPE;
    the encoder-decoder's ``enc_inputs [B,Se,d]`` (frame embeddings) in
    train and prefill.

    * ``"train"``: dense masked attention, no caches; ``aux`` holds the MoE
      layers' mean load-balance loss and dropped fraction (``moe_lb``,
      ``moe_dropped``; zeros in the other modes, where the port does not
      compute them).
    * ``"prefill"``: returns new caches of ``S`` positions, ``lens = S``
      (:func:`pad_caches` makes room to decode).
    * ``"decode"``: appends the Q tokens at ``caches["lens"]`` in place
      (and advances the SSM state in place) and returns the caches with
      ``lens + Q``.

    ``use_kernel`` picks the kernel route of MLA's prefill and decode and
    of the train mode's DSA mask (default: on CUDA tensors) or the plain
    version; GQA attention, the train mode's attention and the SSM are
    plain torch on every device (the reference has no kernel there).
    In train mode each layer body runs under ``cfg.remat``
    (:func:`maybe_remat`).  Logits are fp32."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r}: train | prefill | decode")
    plan = stack_plan(cfg)
    x = _embed_in(params, cfg, inputs)
    lens = caches["lens"] if caches is not None else None
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux: dict[str, Any] = {"moe_lb": zero, "moe_dropped": zero}
    if plan.kind == "lm":
        x, planes, aux = _forward_lm(params, cfg, x, positions, mode, caches,
                                     mrope_positions, use_kernel, aux)
    elif plan.kind == "ssm":
        x, planes = _forward_ssm(params, cfg, x, mode, caches)
    elif plan.kind == "hybrid":
        x, planes = _forward_hybrid(params, cfg, plan, x, positions, mode,
                                    caches)
    else:
        x, planes = _forward_encdec(params, cfg, x, positions, mode, caches,
                                    enc_inputs)

    new_caches = None
    Q = inputs.shape[1]
    if mode == "decode":
        new_caches = {**caches, "lens": lens + Q}
    elif mode == "prefill":
        new_caches = {**(caches or {}), **planes,
                      "lens": torch.full((x.shape[0],), Q, dtype=torch.int64,
                                         device=x.device)}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, cfg, x) if want_logits else None
    return ForwardOut(logits, x, new_caches, aux)


def _lm_layer(lp, cfg, x, positions, mode, csl, lens, is_moe, loc, theta,
              mrope_positions, use_kernel):
    """One layer of the ``lm`` stack: MLA or GQA, then its FFN."""
    if cfg.attn_kind == "mla":
        return B.mla_block(lp, cfg, x, positions, mode=mode, cache=csl,
                           lens=lens, moe=is_moe, train=mode == "train",
                           use_kernel=use_kernel)
    return _gqa_traced(lp, cfg, x, positions, mode, csl, lens, loc, theta,
                       mrope_positions, is_moe)


def _forward_lm(params, cfg, x, positions, mode, caches, mrope_positions,
                use_kernel, aux):
    """The ``lm`` stack: the leading dense layers, then the main group.
    Returns (x, the prefill's new cache planes, aux)."""
    lens = caches["lens"] if caches is not None else None
    key = _cache_key(cfg)
    is_local, theta = layer_meta(cfg, cfg.num_layers)
    run = maybe_remat(_lm_layer, cfg, mode)
    planes, mas = [], []
    for layer in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, layer)
        csl = _layer_cache(caches[key], layer) if mode == "decode" else None
        x, nc, ma = run(lp, cfg, x, positions, mode, csl, lens, is_moe,
                        is_local[layer], theta[layer], mrope_positions,
                        use_kernel)
        if mode == "prefill":
            planes.append(nc)
        if ma is not None:
            mas.append(ma)
    if mas:
        aux = {"moe_lb": torch.stack([a.load_balance_loss
                                      for a in mas]).mean(),
               "moe_dropped": torch.stack([a.dropped_fraction
                                           for a in mas]).mean()}
    return x, ({key: _stacked(planes)} if planes else {}), aux


def _ssm_layers(params, cfg, x, mode, st, layers, states):
    """SSM layers ``layers`` of ``params["layers"]``, each from its view
    of the stacked state ``st`` (decode: advanced in place; prefill: from
    ``st.h`` when given, else zeros); a prefill's new states are appended
    to ``states``."""
    for i in layers:
        s_i = _layer_cache(st, i) if st is not None else None
        x, s_new = B.ssm_block(pick(params["layers"], i), cfg, x, mode=mode,
                               state=s_i if mode != "train" else None)
        if mode == "prefill":
            states.append(s_new)
    return x


def _forward_ssm(params, cfg, x, mode, caches):
    """The Mamba2 stack.  Returns (x, the prefill's new ``ssm`` state)."""
    st = caches["ssm"] if caches is not None else None
    states = []
    x = _ssm_layers(params, cfg, x, mode, st, range(cfg.num_layers), states)
    return x, ({"ssm": _stacked(states)} if states else {})


def _forward_hybrid(params, cfg, plan, x, positions, mode, caches):
    """Zamba2: each group of ``attn_every`` SSM layers is followed by the
    shared attention block ``gi % num_shared_attn`` (its own cache
    ``shared_kv[gi]``), the remainder layers after the groups.  Returns
    (x, the prefill's new ``ssm`` state and ``shared_kv``)."""
    g = cfg.hybrid.attn_every
    lens = caches["lens"] if caches is not None else None
    st = caches["ssm"] if caches is not None else None
    shared = maybe_remat(B.gqa_block, cfg, mode)
    states, kvs = [], []
    for gi in range(plan.hybrid_groups):
        x = _ssm_layers(params, cfg, x, mode, st, range(gi * g, gi * g + g),
                        states)
        csl = _layer_cache(caches["shared_kv"], gi) if mode == "decode" \
            else None
        x, kv_new, _ = shared(
            pick(params["shared_attn"], gi % cfg.hybrid.num_shared_attn),
            cfg, x, positions, mode=mode, kind="global", cache=csl,
            lens=lens, cache_positions=_cache_positions(csl))
        kvs.append(kv_new)
    x = _ssm_layers(params, cfg, x, mode, st,
                    range(plan.hybrid_groups * g, cfg.num_layers), states)
    if mode != "prefill":
        return x, {}
    return x, {"ssm": _stacked(states), "shared_kv": _stacked(kvs)}


def _enc_layer(lp, cfg, e, epos, zero):
    """One encoder layer: dense unmasked attention, then the MLP."""
    h = L.rmsnorm(lp["ln1"], e, cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], cfg, h, epos)
    q = shard(q, "batch", "seq_sp", None, None)
    o = A.mha_dense(q, k, v, zero, cfg.head_dim ** -0.5, None)
    e = e + L.proj(o, lp["attn"]["wo"], 2)
    e = e + L.mlp(lp["ffn"], L.rmsnorm(lp["ln2"], e, cfg.norm_eps), cfg.act)
    return shard(e, "batch", "seq_sp", None)


def _encode(params, cfg, enc_inputs, dtype, mode):
    """Whisper's encoder over the frame embeddings ``[B,Se,d]``: dense
    unmasked attention (RoPE on the frame positions, the reference's stub),
    the MLP, then ``enc_norm``."""
    e = enc_inputs.to(dtype)
    epos = torch.arange(e.shape[1], device=e.device)[None].expand(
        e.shape[:2])
    zero = torch.zeros((), dtype=torch.float32, device=e.device)
    run = maybe_remat(_enc_layer, cfg, mode)
    for i in range(cfg.encdec.encoder_layers):
        e = run(pick(params["encoder"], i), cfg, e, epos, zero)
    return L.rmsnorm(params["enc_norm"], e, cfg.norm_eps)


def _forward_encdec(params, cfg, x, positions, mode, caches, enc_inputs):
    """Whisper's backbone: outside decode the encoder runs and each
    decoder layer's cross k / v is computed from its output; a decode
    step reads them from ``caches["enc_kv"]``.  Returns (x, the prefill's
    new ``kv`` and ``enc_kv``)."""
    lens = caches["lens"] if caches is not None else None
    if mode == "decode":
        enc_kv = caches["enc_kv"]
    else:
        if enc_inputs is None:
            raise ValueError(f"{cfg.name}: {mode} needs enc_inputs")
        e = _encode(params, cfg, enc_inputs, x.dtype, mode)
        enc_kv = _stacked([B.GQACache(*A.cross_kv(
            pick(params["decoder"], i)["cross"], cfg, e))
            for i in range(cfg.num_layers)])
        del e
    run = maybe_remat(B.gqa_block, cfg, mode)
    kvs = []
    for i in range(cfg.num_layers):
        csl = _layer_cache(caches["kv"], i) if mode == "decode" else None
        x, kv_new, _ = run(
            pick(params["decoder"], i), cfg, x, positions, mode=mode,
            kind="global", cache=csl, lens=lens,
            cache_positions=_cache_positions(csl),
            enc_kv=_layer_cache(enc_kv, i))
        x = shard(x, "batch", "seq_sp", None)
        kvs.append(kv_new)
    if mode != "prefill":
        return x, {}
    return x, {"kv": _stacked(kvs), "enc_kv": enc_kv}
