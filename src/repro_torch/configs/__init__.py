"""Architecture registry — importing this package registers the configs."""

from repro_torch.configs.base import (ArchConfig, DSAConfig, ESSOptions,
                                      MLAConfig, MoEConfig, get_config)
from repro_torch.configs import (dbrx_132b, deepseek_v3_671b,  # noqa: F401
                                 gemma2_27b, gemma3_27b,       # (registers)
                                 qwen1_5_110b, qwen2_vl_7b, qwen3_0_6b)
from repro_torch.configs.deepseek_v3_671b import cut_depth

__all__ = ["ArchConfig", "DSAConfig", "ESSOptions", "MLAConfig", "MoEConfig",
           "cut_depth", "get_config"]
