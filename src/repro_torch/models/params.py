"""Parameter trees of the decoder stacks (counterpart of
``repro.models.params`` + the tree layout of ``repro.models.transformer
.model_def`` and the block definitions of ``repro.models.blocks``: the MLA
block with or without the DSA indexer, the GQA block of
:func:`repro_torch.models.attention.attn_def`).

A parameter tree is a nested ``dict`` of tensors with the reference's key
names and shapes: ``embed`` (absent under ``embedding_inputs``),
``unembed`` (untied configs), ``final_norm``, ``dense_layers`` and
``layers`` (each leaf stacked on a leading layer axis) and ``mtp``.

* :func:`from_jax_params` carries the reference's own parameters across
  (handed over as nested dicts of numpy arrays), bit for bit.
* :func:`init_params` builds the same tree on the card with the same
  init families (its random numbers differ from JAX's: a
  ``torch.Generator`` is not a JAX key).  The MTP modules draw from a
  generator of their own (:func:`init_mtp_params`), so the backbone's
  weights from a seed are the same with and without them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One leaf: shape, dtype and init family (normal | zeros | embed)."""
    shape: tuple[int, ...]
    dtype: Any
    init: str = "normal"
    scale: float | None = None


# ---------------------------------------------------------------------------
# Definition tree (same keys / shapes / families as the reference)
# ---------------------------------------------------------------------------

def _norm(dim: int, dt) -> ParamDef:
    return ParamDef((dim,), dt, "zeros")           # zero-centred (1 + w)


def _mlp_def(d: int, f: int, dt) -> dict:
    return {"wo": ParamDef((f, d), dt), "wi_gate": ParamDef((d, f), dt),
            "wi_up": ParamDef((d, f), dt)}


def _mla_def(cfg: ArchConfig) -> dict:
    m, dt = cfg.mla, cfg.param_dtype
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDef((d, m.q_lora_rank), dt),
        "q_norm": _norm(m.q_lora_rank, dt),
        "w_uq": ParamDef((m.q_lora_rank, H, qk), dt),
        "w_dkv": ParamDef((d, m.kv_lora_rank), dt),
        "kv_norm": _norm(m.kv_lora_rank, dt),
        "w_kr": ParamDef((d, m.qk_rope_head_dim), dt),
        "w_uk": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim), dt),
        "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim), dt),
        "wo": ParamDef((H, m.v_head_dim, d), dt),
    }


def _indexer_def(cfg: ArchConfig) -> dict:
    i, dt, d = cfg.dsa, cfg.param_dtype, cfg.d_model
    return {"w_iq": ParamDef((d, i.index_heads, i.index_dim), dt),
            "w_ik": ParamDef((d, i.index_dim), dt),
            "w_iw": ParamDef((d, i.index_heads), dt, scale=0.02)}


def _moe_def(cfg: ArchConfig) -> dict:
    mo, dt = cfg.moe, cfg.param_dtype
    d, E, f = cfg.d_model, mo.num_experts, mo.d_expert
    p = {"router": ParamDef((d, E), torch.float32),
         "w_gate": ParamDef((E, d, f), dt),
         "w_up": ParamDef((E, d, f), dt),
         "w_down": ParamDef((E, f, d), dt)}
    if mo.router_bias:
        p["router_bias"] = ParamDef((E,), torch.float32, "zeros")
    if mo.num_shared:
        p["shared"] = _mlp_def(d, f * mo.num_shared, dt)
    return p


def _block_def(cfg: ArchConfig, *, moe: bool, dense_ff: int | None = None
               ) -> dict:
    """One layer's definitions: the MLA block (``attn_kind == "mla"``,
    the indexer with DSA) or the GQA block (gemma's post-norms)."""
    dt, d = cfg.param_dtype, cfg.d_model
    if cfg.attn_kind == "mla":
        p = {"ln1": _norm(d, dt), "mla": _mla_def(cfg), "ln2": _norm(d, dt)}
        if cfg.dsa is not None:
            p["indexer"] = _indexer_def(cfg)
    else:
        from repro_torch.models.attention import attn_def
        p = {"ln1": _norm(d, dt), "attn": attn_def(cfg), "ln2": _norm(d, dt)}
        if cfg.post_block_norm:
            p["ln1_post"] = _norm(d, dt)
            p["ln2_post"] = _norm(d, dt)
    p["ffn"] = _moe_def(cfg) if moe else _mlp_def(d, dense_ff or cfg.d_ff, dt)
    return p


def _stack(defs: dict, n: int) -> dict:
    return {k: (_stack(v, n) if isinstance(v, dict) else
                dataclasses.replace(v, shape=(n,) + v.shape))
            for k, v in defs.items()}


def model_def(cfg: ArchConfig) -> dict:
    """Definition tree of the whole decoder (the reference's layout)."""
    dt = cfg.param_dtype
    defs: dict[str, Any] = {"final_norm": _norm(cfg.d_model, dt)}
    if not cfg.embedding_inputs:
        defs["embed"] = ParamDef((cfg.vocab_size, cfg.d_model), dt, "embed")
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.vocab_size, cfg.d_model), dt, "embed")
    nd = cfg.moe.first_dense_layers if cfg.moe else 0
    if nd:
        defs["dense_layers"] = _stack(
            _block_def(cfg, moe=False,
                       dense_ff=cfg.moe.dense_d_ff or cfg.d_ff), nd)
    defs["layers"] = _stack(_block_def(cfg, moe=cfg.moe is not None),
                            cfg.num_layers - nd)
    if cfg.mtp_depth:
        defs["mtp"] = _stack({
            "ln_h": _norm(cfg.d_model, dt), "ln_e": _norm(cfg.d_model, dt),
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model), dt),
            "block": _block_def(cfg, moe=cfg.moe is not None)},
            cfg.mtp_depth)
    return defs


def count_params(defs: dict) -> int:
    """Elements of a definition tree, none materialized."""
    if isinstance(defs, dict):
        return sum(count_params(v) for v in defs.values())
    return int(np.prod(defs.shape))


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

# elements generated per randn call: bounds the fp32 staging tensor of the
# 7.5 GB expert stacks to 1 GiB
_CHUNK_ELEMS = 1 << 28


def _materialize(d: ParamDef, g: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = d.scale if d.scale is not None else 0.02
    else:
        # fan-in = every dim but the last, stacked layer axis included,
        # exactly as the reference's ParamDef does
        fan_in = max(1, int(np.prod(d.shape[:-1])))
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    flat = out.view(-1, d.shape[-1])
    step = max(1, _CHUNK_ELEMS // d.shape[-1])
    for r0 in range(0, flat.shape[0], step):
        r1 = min(flat.shape[0], r0 + step)
        z = torch.randn((r1 - r0, d.shape[-1]), generator=g, device=device,
                        dtype=torch.float32)
        flat[r0:r1] = (z * std).to(d.dtype)
    return out


def _map_defs(fn, defs):
    if isinstance(defs, dict):
        return {k: _map_defs(fn, defs[k]) for k in sorted(defs)}
    return fn(defs)


# the MTP modules' generator is seeded with the model's seed plus this
MTP_SEED_OFFSET = 1 << 20


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_params(cfg: ArchConfig, generator: torch.Generator | int = 0,
                device=None) -> dict:
    """Random parameters for ``cfg`` on ``device`` (the card by default).

    ``generator`` is a ``torch.Generator`` on that device, or an int seed.
    Leaves are drawn in the reference's flatten order (sorted keys); the
    ``mtp`` subtree comes from :func:`init_mtp_params` with the seed
    (a generator's initial seed), so the rest does not depend on it."""
    dev = resolve_device(device)
    g = _generator(generator, dev) if isinstance(generator, int) \
        else generator
    defs = model_def(cfg)
    mtp = defs.pop("mtp", None)
    params = _map_defs(lambda d: _materialize(d, g, dev), defs)
    if mtp is not None:
        seed = generator if isinstance(generator, int) \
            else generator.initial_seed()
        params["mtp"] = init_mtp_params(cfg, seed, dev)
    return params


def init_mtp_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """The ``mtp`` subtree alone (``cfg.mtp_depth`` stacked modules), from
    a generator seeded with ``seed + MTP_SEED_OFFSET``: added to a
    backbone drawn from ``seed`` it gives :func:`init_params`' tree."""
    dev = resolve_device(device)
    if not cfg.mtp_depth:
        raise ValueError(f"{cfg.name} has no MTP module (mtp_depth 0)")
    g = _generator(seed + MTP_SEED_OFFSET, dev)
    return _map_defs(lambda d: _materialize(d, g, dev),
                     model_def(cfg)["mtp"])


# ---------------------------------------------------------------------------
# The bridge from the reference's pytree
# ---------------------------------------------------------------------------

# numpy dtypes torch.from_numpy refuses (ml_dtypes), by name -> the integer
# view that crosses and the torch dtype it is reinterpreted as
_VIEW_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def array_to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy array (ml_dtypes included) -> tensor, bit for bit."""
    a = np.ascontiguousarray(np.asarray(a))
    name = a.dtype.name
    if name in _VIEW_DTYPES:
        view, tdt = _VIEW_DTYPES[name]
        t = torch.from_numpy(a.view(view).copy()).view(tdt)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_params(tree, device="cpu"):
    """Nested dicts of numpy arrays (the reference's parameter pytree after
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors.

    Every leaf converts, unused ``mtp`` leaves included."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return array_to_torch(tree, device)
