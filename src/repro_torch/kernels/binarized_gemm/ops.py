"""Public op: the binarized GEMM (counterpart of
``repro.kernels.binarized_gemm.ops``), the BNN primitive of N2Net.

``binarized_gemm`` launches CUDA kernel K9 (``csrc/binarized_gemm.cu``)
for CUDA tensors and runs the plain version (``ref.binarized_gemm_ref``)
for CPU tensors.  There is no other switch and no fallback.

x [B, K] and w [K, N], each f32 or bf16, -> int32 [B, N], the exact
integer dot products of the +-1 sign vectors (sign(v) = +1 where v >= 0).
Any B, K and N of at least 1 work.  One call is two launches: the
signs of both operands as int8 (x's [B, Kp], w's transposed to [N, Kp],
Kp = K rounded up to ``K_TILE`` with zeros past K, so the padding adds
nothing; the JAX op pads K with -1e-9 and subtracts the padding's
contribution afterwards), then their product on the int8 tensor cores;
``ref.sign_pack_ref`` is the first launch's plain version.  No path runs
it: the JAX package has no stage that lowers onto it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.binarized_gemm.ref import binarized_gemm_ref

DTYPES = (torch.float32, torch.bfloat16)
K_TILE = _ext.header_define("BG_KTILE")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be [B, K] and w [K, N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if min(x.shape[0], x.shape[1], w.shape[1]) < 1:
        raise ValueError(f"B, K and N must be >= 1; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    for t in (x, w):
        if t.dtype not in DTYPES:
            raise ValueError(f"the binarized GEMM takes f32 or bf16; got "
                             f"{t.dtype}")


def binarized_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w) -> int32 [B, N].  CUDA tensors: one K9 call;
    CPU tensors: the plain product."""
    if x.device.type == "cpu":
        _check(x, w)
        return binarized_gemm_ref(x, w).to(torch.int32)
    return binarized_gemm_launch(x, w)


def binarized_gemm_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K9's wrapper: checked operands -> int32 [B, N].  One call writes
    both operands' signs into int8 scratch and multiplies them on the
    tensor cores, on the current stream.  Raises under autograd (no
    backward on the card yet)."""
    _ext.refuse_grad("binarized_gemm", (x, w))
    _check(x, w)
    for t in (x, w):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("binarized_gemm_launch runs CUDA tensors of one "
                             f"device; got {t.device} beside {x.device}")
        if not t.is_contiguous():
            raise ValueError("binarized_gemm_launch takes contiguous tensors")
    (B, K), N = x.shape, w.shape[1]
    kp = -(-K // K_TILE) * K_TILE
    xs = torch.empty((B, kp), dtype=torch.int8, device=x.device)
    wt = torch.empty((N, kp), dtype=torch.int8, device=x.device)
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    _ext.extension().binarized_gemm(x, w, xs, wt, out)
    _ext.count_launch("binarized_gemm")
    return out
