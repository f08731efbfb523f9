"""Plain PyTorch version of K9 (counterpart of
``repro.kernels.binarized_gemm.ref``): the binarized (+-1) matrix
product, sign(x) @ sign(w), with sign(v) = +1 where v >= 0 and -1
elsewhere (so -0.0 gives +1 and NaN -1).  The products of +-1 values are
summed in float32, exact for K < 2**24.  The CPU tests hold it against
the reference's oracle, and ``chip_smoke.py`` holds the kernel against
it on the card."""

from __future__ import annotations

import torch


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) = sign(-0.0) = +1 and sign(NaN) = -1, as f32."""
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def binarized_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, K], w [K, N] (real-valued) -> sign(x) @ sign(w), f32 [B, N]."""
    return sign_pm1(x) @ sign_pm1(w)
