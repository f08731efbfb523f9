from repro_torch.kernels.binarized_gemm.ops import (
    K_TILE,
    binarized_gemm,
    binarized_gemm_launch,
)
from repro_torch.kernels.binarized_gemm.ref import (
    binarized_gemm_ref,
    sign_pack_ref,
    sign_pm1,
)
