"""whisper-large-v3 [audio] — encoder-decoder backbone, conv front end
stubbed: the encoder takes precomputed frame embeddings.

32L (enc) + 32L (dec) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
[arXiv:2212.04356]

(Own copy of ``repro.configs.whisper_large_v3``.)
"""

from repro_torch.configs.base import ArchConfig, EncDecConfig, register

# the decoder's text context (whisper's n_text_ctx)
TEXT_CTX = 448


@register("whisper-large-v3")
def whisper_large_v3() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,                      # decoder layers
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=1280 // 20,
        d_ff=5120,
        vocab_size=51866,
        attn_kind="gqa",
        qkv_bias=True,
        act="gelu",
        encdec=EncDecConfig(encoder_layers=32, encoder_seq=1500,
                            cross_kv_heads=20),
        tie_embeddings=True,
    )


@register("whisper-large-v3-smoke")
def whisper_large_v3_smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="gqa",
        qkv_bias=True,
        act="gelu",
        encdec=EncDecConfig(encoder_layers=2, encoder_seq=32,
                            cross_kv_heads=4),
    )
