"""gemma2-27b [dense] — local+global alternating, logit softcap.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
[arXiv:2408.00118; hf]

(Own copy of ``repro.configs.gemma2_27b``.)
"""

from repro_torch.configs.base import ArchConfig, register


@register("gemma2-27b")
def gemma2_27b() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        attn_kind="gqa",
        sliding_window=4096,
        layer_pattern=("local", "global"),
        logit_softcap=30.0,
        attn_softcap=50.0,
        query_scale=(4608 // 32) ** -0.5,      # query_pre_attn_scalar=144
        post_block_norm=True,
        scale_embeddings=True,
        act="gelu_tanh",
    )


@register("gemma2-27b-smoke")
def gemma2_27b_smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b-smoke",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        attn_kind="gqa",
        sliding_window=16,
        layer_pattern=("local", "global"),
        logit_softcap=30.0,
        attn_softcap=50.0,
        query_scale=16.0 ** -0.5,
        post_block_norm=True,
        scale_embeddings=True,
        act="gelu_tanh",
    )
