from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "list_archs", "register"]
