"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.  [arXiv:2405.21060]

(Own copy of ``repro.configs.mamba2_780m``.)
"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("mamba2-780m")
def mamba2_780m() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      ngroups=1, chunk=256),
    )


@register("mamba2-780m-smoke")
def mamba2_780m_smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        attn_kind="none",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      ngroups=1, chunk=16),
    )
