"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (vision frontend STUB).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
[arXiv:2409.12191; hf]  input_specs() provides precomputed patch embeddings.

(Own copy of ``repro.configs.qwen2_vl_7b``.)
"""

from repro_torch.configs.base import ArchConfig, register


@register("qwen2-vl-7b")
def qwen2_vl_7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        attn_kind="gqa",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),       # t/h/w frequency pairs, sum=64
        embedding_inputs=True,             # patch/text embeds precomputed
        tie_embeddings=False,
    )


@register("qwen2-vl-7b-smoke")
def qwen2_vl_7b_smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b-smoke",
        family="vlm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="gqa",
        qkv_bias=True,
        mrope_sections=(2, 3, 3),
        embedding_inputs=True,
        tie_embeddings=False,
    )
