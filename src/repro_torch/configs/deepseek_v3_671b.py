"""DeepSeek-V3 and V3.2-Exp with ESS (own copy of
``repro.configs.deepseek_v3_671b``).

61L d_model=7168 128H, MLA (latent 576), MoE 256e top-8 + 1 shared, 3
leading dense layers, vocab 129280, MTP depth 1.

* ``deepseek-v3-671b``           — V3: dense MLA over the latent cache.
* ``deepseek-v32-exp-ess``       — V3.2-Exp: + the DSA lightning indexer
  64x128 top-2048, with ESS's offload settings.
* ``-smoke`` variants            — the same code paths at laptop scale.
"""

import dataclasses

from repro_torch.configs.base import (ArchConfig, DSAConfig, ESSOptions,
                                      MLAConfig, MoEConfig, register)


def _base(name: str, dsa, ess) -> ArchConfig:
    return ArchConfig(
        name=name,
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,                    # dense-layer d_ff
        vocab_size=129280,
        attn_kind="mla",
        rope_theta=10_000.0,
        tie_embeddings=False,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        dsa=dsa,
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      num_shared=1, first_dense_layers=3, dense_d_ff=18432,
                      capacity_factor=1.25, router_bias=True,
                      routed_scale=2.5, norm_topk=True),
        mtp_depth=1,
        ess=ess,
        sharding_profile="2d",
    )


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ArchConfig:
    return _base("deepseek-v3-671b", dsa=None, ess=ESSOptions())


@register("deepseek-v32-exp-ess")
def deepseek_v32_exp_ess() -> ArchConfig:
    return _base("deepseek-v32-exp-ess",
                 dsa=DSAConfig(index_heads=64, index_dim=128, index_topk=2048),
                 ess=ESSOptions(sparse_memory_ratio=0.25,
                                max_miss_ratio=0.125, warmup_windows=32,
                                overlap="layerwise", offload_kv=True,
                                host_page_rows=64))


@register("deepseek-v3-671b-smoke")
def deepseek_v3_671b_smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="mla",
        tie_embeddings=False,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        dsa=None,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, num_shared=1,
                      first_dense_layers=1, dense_d_ff=128,
                      capacity_factor=2.0, router_bias=True,
                      routed_scale=1.0),
        mtp_depth=1,
        sharding_profile="2d",
    )


@register("deepseek-v32-exp-ess-smoke")
def deepseek_v32_exp_ess_smoke() -> ArchConfig:
    return dataclasses.replace(
        deepseek_v3_671b_smoke(), name="deepseek-v32-exp-ess-smoke",
        dsa=DSAConfig(index_heads=2, index_dim=16, index_topk=8),
        ess=ESSOptions(sparse_memory_ratio=0.5, max_miss_ratio=0.5,
                       warmup_windows=4, overlap="da", pool_min_entries=8))


def cut_depth(cfg: ArchConfig, num_layers: int, *,
              keep_mtp: bool = False) -> ArchConfig:
    """The chip configuration's cuts: fewer layers and, unless
    ``keep_mtp``, no MTP module (``keep_mtp`` keeps the published ones).

    Widths are untouched; ``num_layers`` keeps the model's own leading
    dense layers first, so a cut to ``first_dense_layers + 1`` still runs
    both FFN kinds."""
    return dataclasses.replace(cfg, num_layers=num_layers,
                               mtp_depth=cfg.mtp_depth if keep_mtp else 0)
