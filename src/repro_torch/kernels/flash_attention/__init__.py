from repro_torch.kernels.flash_attention.ops import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_launch,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
