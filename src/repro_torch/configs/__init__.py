"""Architecture registry — importing this package registers the configs."""

from repro_torch.configs.base import (ArchConfig, DSAConfig, EncDecConfig,
                                      ESSOptions, HybridConfig, MLAConfig,
                                      MoEConfig, SHAPES, ShapeCell,
                                      SSMConfig, ess_enabled, get_config)
from repro_torch.configs import (dbrx_132b, deepseek_v3_671b,  # noqa: F401
                                 gemma2_27b, gemma3_27b,       # (registers)
                                 mamba2_780m, qwen1_5_110b, qwen2_vl_7b,
                                 qwen3_0_6b, whisper_large_v3, zamba2_7b)
from repro_torch.configs.deepseek_v3_671b import cut_depth

# the ten assigned architectures (the dry run's rows)
ASSIGNED = [
    "zamba2-7b", "whisper-large-v3", "gemma2-27b", "gemma3-27b",
    "qwen3-0.6b", "qwen1.5-110b", "dbrx-132b", "deepseek-v3-671b",
    "qwen2-vl-7b", "mamba2-780m",
]

__all__ = ["ASSIGNED", "ArchConfig", "DSAConfig", "EncDecConfig",
           "ESSOptions", "HybridConfig", "MLAConfig", "MoEConfig", "SHAPES",
           "SSMConfig", "ShapeCell", "cut_depth", "ess_enabled",
           "get_config"]
