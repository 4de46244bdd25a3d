"""qwen1.5-110b [dense] — QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
[hf:Qwen/Qwen1.5-0.5B; hf]

(Own copy of ``repro.configs.qwen1_5_110b``.)
"""

from repro_torch.configs.base import ArchConfig, register


@register("qwen1.5-110b")
def qwen1_5_110b() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        attn_kind="gqa",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        sharding_profile="2d",
    )


@register("qwen1.5-110b-smoke")
def qwen1_5_110b_smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab_size=256,
        attn_kind="gqa",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        sharding_profile="2d",
    )
