"""Model configurations (counterpart of ``repro.configs``): the dense
family, the MoE Moonshot and the hybrid Jamba, each with its published
config and its smoke config."""

from repro_torch.configs.base import (
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

# Import the architecture modules so they self-register.
from repro_torch.configs import (  # noqa: F401
    jamba_1_5_large_398b,
    moonshot_v1_16b_a3b,
    qwen1_5_32b,
    qwen2_7b,
    qwen3_1_7b,
    starcoder2_15b,
)

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
