"""Architecture registry — importing this package registers the configs."""

from repro_torch.configs.base import (ArchConfig, DSAConfig, EncDecConfig,
                                      ESSOptions, HybridConfig, MLAConfig,
                                      MoEConfig, SSMConfig, get_config)
from repro_torch.configs import (dbrx_132b, deepseek_v3_671b,  # noqa: F401
                                 gemma2_27b, gemma3_27b,       # (registers)
                                 mamba2_780m, qwen1_5_110b, qwen2_vl_7b,
                                 qwen3_0_6b, whisper_large_v3, zamba2_7b)
from repro_torch.configs.deepseek_v3_671b import cut_depth

__all__ = ["ArchConfig", "DSAConfig", "EncDecConfig", "ESSOptions",
           "HybridConfig", "MLAConfig", "MoEConfig", "SSMConfig", "cut_depth",
           "get_config"]
