"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32, MHA shared blocks) d_ff=14336 vocab=32000,
ssm_state=64.  [arXiv:2411.15242; unverified]

(Own copy of ``repro.configs.zamba2_7b``.)
"""

from repro_torch.configs.base import (ArchConfig, HybridConfig, SSMConfig,
                                      register)


@register("zamba2-7b")
def zamba2_7b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=3584 // 32,
        d_ff=14336,
        vocab_size=32000,
        attn_kind="gqa",
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      ngroups=1, chunk=128),
        hybrid=HybridConfig(attn_every=6, num_shared_attn=2),
    )


@register("zamba2-7b-smoke")
def zamba2_7b_smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        num_layers=7,               # 2 groups of 3 + a remainder layer
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="gqa",
        ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, conv_width=4,
                      ngroups=1, chunk=16),
        hybrid=HybridConfig(attn_every=3, num_shared_attn=2),
    )
