"""qwen3-0.6b [dense] — qk_norm, GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
[hf:Qwen/Qwen3-8B; hf]

(Own copy of ``repro.configs.qwen3_0_6b``.)
"""

from repro_torch.configs.base import ArchConfig, register


@register("qwen3-0.6b")
def qwen3_0_6b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        attn_kind="gqa",
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


@register("qwen3-0.6b-smoke")
def qwen3_0_6b_smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="gqa",
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
