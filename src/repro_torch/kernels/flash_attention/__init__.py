from repro_torch.kernels.flash_attention.ops import (
    DECODE_MAX_SQ,
    HEAD_DIMS,
    decode_plan,
    flash_attention,
    flash_attention_launch,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    attention_ref,
    attention_split_ref,
    live_keys,
)
