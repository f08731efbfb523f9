from repro_torch.kernels.flash_attention.ops import (
    DECODE_MAX_SQ,
    HEAD_DIMS,
    FlashAttentionFn,
    decode_plan,
    flash_attention,
    flash_attention_bwd_launch,
    flash_attention_launch,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    attention_bwd_ref,
    attention_ref,
    attention_split_ref,
    first_masked_row,
    live_keys,
)
