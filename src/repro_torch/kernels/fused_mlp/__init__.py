from repro_torch.kernels.fused_mlp.ops import (
    PackedMLP,
    fused_mlp_classify,
    fused_mlp_classify_launch,
    fused_mlp_classify_packed,
    pack_params,
)
from repro_torch.kernels.fused_mlp.ref import mlp_classify_ref, mlp_ref
