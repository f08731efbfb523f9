"""Plain PyTorch version of K9 (counterpart of
``repro.kernels.binarized_gemm.ref``): the binarized (+-1) matrix
product, sign(x) @ sign(w), with sign(v) = +1 where v >= 0 and -1
elsewhere (so -0.0 gives +1 and NaN -1).  The products of +-1 values are
summed in float32, exact for K < 2**24.  The CPU tests hold it against
the reference's oracle, and ``chip_smoke.py`` holds the kernel against
it on the card.  ``sign_pack_ref`` is the plain version of K9's first
launch: the int8 signs its product reads."""

from __future__ import annotations

import torch


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) = sign(-0.0) = +1 and sign(NaN) = -1, as f32."""
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def binarized_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, K], w [K, N] (real-valued) -> sign(x) @ sign(w), f32 [B, N]."""
    return sign_pm1(x) @ sign_pm1(w)


def sign_pack_ref(x: torch.Tensor, w: torch.Tensor, k_tile: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, K], w [K, N] -> (xs [B, Kp], wt [N, Kp]) int8 +-1, w's signs
    transposed, Kp = K rounded up to ``k_tile`` and zero past K (so
    ``xs.int() @ wt.int().T`` is sign(x) @ sign(w))."""
    (B, K), N = x.shape, w.shape[1]
    kp = -(-K // k_tile) * k_tile
    xs = torch.zeros((B, kp), dtype=torch.int8, device=x.device)
    wt = torch.zeros((N, kp), dtype=torch.int8, device=x.device)
    xs[:, :K] = sign_pm1(x).to(torch.int8)
    wt[:, :K] = sign_pm1(w).to(torch.int8).T
    return xs, wt

