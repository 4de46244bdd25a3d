"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
[hf:databricks/dbrx-base; unverified]

(Own copy of ``repro.configs.dbrx_132b``.)
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("dbrx-132b")
def dbrx_132b() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        attn_kind="gqa",
        rope_theta=500_000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752,
                      num_shared=0, capacity_factor=1.25, norm_topk=True),
        sharding_profile="2d",
    )


@register("dbrx-132b-smoke")
def dbrx_132b_smoke() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attn_kind="gqa",
        rope_theta=500_000.0,
        tie_embeddings=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=96,
                      capacity_factor=2.0, norm_topk=True),
        sharding_profile="2d",
    )
