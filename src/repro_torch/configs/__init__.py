"""Architecture registry — importing this package registers the configs."""

from repro_torch.configs.base import (ArchConfig, DSAConfig, ESSOptions,
                                      MLAConfig, MoEConfig, get_config)
from repro_torch.configs import deepseek_v3_671b  # noqa: F401  (registers)
from repro_torch.configs.deepseek_v3_671b import cut_depth

__all__ = ["ArchConfig", "DSAConfig", "ESSOptions", "MLAConfig", "MoEConfig",
           "cut_depth", "get_config"]
