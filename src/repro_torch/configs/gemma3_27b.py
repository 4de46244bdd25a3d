"""gemma3-27b [dense] — 5:1 local:global, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]

(Own copy of ``repro.configs.gemma3_27b``.)
"""

from repro_torch.configs.base import ArchConfig, register


@register("gemma3-27b")
def gemma3_27b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        attn_kind="gqa",
        qk_norm=True,
        sliding_window=1024,
        layer_pattern=("local",) * 5 + ("global",),
        rope_theta=1_000_000.0,            # global layers
        local_rope_theta=10_000.0,         # local layers
        query_scale=(5376 // 32) ** -0.5,
        post_block_norm=True,
        scale_embeddings=True,
        act="gelu_tanh",
    )


@register("gemma3-27b-smoke")
def gemma3_27b_smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b-smoke",
        family="dense",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="gqa",
        qk_norm=True,
        sliding_window=8,
        layer_pattern=("local",) * 5 + ("global",),
        rope_theta=1_000_000.0,
        local_rope_theta=10_000.0,
        query_scale=16.0 ** -0.5,
        post_block_norm=True,
        scale_embeddings=True,
        act="gelu_tanh",
    )
