"""Model configurations (counterpart of ``repro.configs``): the
reference's ten architectures, each with its published config and its
smoke config."""

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

# Import the architecture modules so they self-register.
from repro_torch.configs import (  # noqa: F401
    jamba_1_5_large_398b,
    llama_3_2_vision_11b,
    mixtral_8x7b,
    moonshot_v1_16b_a3b,
    qwen1_5_32b,
    qwen2_7b,
    qwen3_1_7b,
    seamless_m4t_large_v2,
    starcoder2_15b,
    xlstm_1_3b,
)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "applicable_shapes",
           "get_config", "get_smoke_config", "list_archs", "register"]
