"""Architecture config dataclasses (own copy of the fields of
``repro.configs.base`` that the port uses).

``param_dtype`` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def latent_dim(self) -> int:           # cached per token: c_kv ++ k_rope
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """DeepSeek Sparse Attention (V3.2-Exp lightning indexer)."""
    index_heads: int = 64
    index_dim: int = 128
    index_topk: int = 2048


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 4
    d_expert: int = 2048            # per-expert intermediate dim
    num_shared: int = 0             # shared (always-on) experts
    first_dense_layers: int = 0     # leading dense layers (deepseek: 3)
    dense_d_ff: int = 0             # d_ff of those dense layers
    capacity_factor: float = 1.25   # fixed-capacity dispatch
    router_bias: bool = False       # aux-loss-free bias routing (deepseek)
    routed_scale: float = 1.0       # deepseek routed_scaling_factor
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    ngroups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: SSM backbone + shared attention block every N layers."""
    attn_every: int = 6
    num_shared_attn: int = 2        # alternating shared transformer blocks


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 32
    encoder_seq: int = 1500         # whisper frame count after conv stub
    cross_kv_heads: int = 20


@dataclasses.dataclass(frozen=True)
class ESSOptions:
    """Paper technique switches (see repro_torch.core)."""
    sparse_memory_ratio: float = 0.3   # pool entries / context entries
    max_miss_ratio: float = 0.25       # miss buffer size / top-k
    warmup_windows: int = 32
    overlap: str = "da"                # none | da | dba | layerwise
    offload_kv: bool = True            # host tier for the full cache
    pool_min_entries: int = 6400       # paper: ">= 6.4K" recommendation
    paged_host: bool = True            # global page pool + block tables
    host_page_rows: int = 16           # latent rows per host page
    host_cache_dtype: str = "bf16"     # bf16 | int8 | fp8 (e4m3)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ``ArchConfig`` fields that the port reads, with the
    reference's defaults (its sharding and scan fields are not ported: the
    port runs every stack unrolled on one card).  ``remat`` is the
    activation checkpointing of each layer body in train mode
    (:func:`repro_torch.models.transformer.maybe_remat`)."""
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    attn_kind: str = "gqa"             # gqa | mla | none
    # attention details
    rope_theta: float = 10000.0
    rope_interleaved: bool = False
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    query_scale: Optional[float] = None   # overrides head_dim**-0.5 (gemma)
    # block kinds repeated, e.g. ("local", "global"); None: all "global"
    layer_pattern: Optional[tuple[str, ...]] = None
    post_block_norm: bool = False      # gemma2/3 post-norms
    tie_embeddings: bool = True
    scale_embeddings: bool = False     # gemma: x *= sqrt(d_model)
    act: str = "silu"
    norm_eps: float = 1e-6
    local_rope_theta: Optional[float] = None   # gemma3 local layers
    mla: Optional[MLAConfig] = None
    dsa: Optional[DSAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    mrope_sections: Optional[tuple[int, ...]] = None   # qwen2-vl
    ess: ESSOptions = ESSOptions()
    remat: str = "dots"                # none | full | dots  (train-time)
    param_dtype: Any = torch.bfloat16
    # inputs are precomputed embeddings [B,S,d], not token ids (qwen2-vl)
    embedding_inputs: bool = False
    mtp_depth: int = 0                 # multi-token-prediction modules

    def pattern_at(self, layer: int) -> str:
        if self.layer_pattern is None:
            return "global"
        return self.layer_pattern[layer % len(self.layer_pattern)]


_REGISTRY: dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registration side effect)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
