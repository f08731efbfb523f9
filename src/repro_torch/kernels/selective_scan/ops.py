"""Public op: the Mamba selective scan (counterpart of
``repro.kernels.selective_scan.ops``).

``selective_scan`` launches CUDA kernel K8 (``csrc/selective_scan.cu``)
for CUDA tensors and runs the plain version (``ref.selective_scan_ref``)
for CPU tensors.  There is no other switch and no fallback.

It takes the discretized inputs, as the reference's kernel does: dA and
dBx [B, S, di, N], C [B, S, N] and h0 [B, di, N], all f32, with N a
power of two up to 32 (one warp's lanes hold a channel's states); ->
(y [B, S, di], h_final [B, di, N]).  Any S works, 1 included: the chunk
rule of the Mamba block (``models.ssm``) is the block's, not the scan's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

# the state widths K8 takes (a template parameter): N lanes of a warp
STATE_WIDTHS = (1, 2, 4, 8, 16, 32)


def _check(deltaA, deltaBx, C, h0) -> None:
    if deltaA.dim() != 4 or deltaBx.shape != deltaA.shape:
        raise ValueError("dA and dBx must be one [B, S, di, N] shape; got "
                         f"{tuple(deltaA.shape)}, {tuple(deltaBx.shape)}")
    B, S, di, N = deltaA.shape
    if tuple(C.shape) != (B, S, N) or tuple(h0.shape) != (B, di, N):
        raise ValueError(f"C must be [B, S, N] = {(B, S, N)} and h0 [B, di, "
                         f"N] = {(B, di, N)}; got {tuple(C.shape)}, "
                         f"{tuple(h0.shape)}")
    if N not in STATE_WIDTHS:
        raise ValueError(f"state width N={N} is not one K8 takes "
                         f"{STATE_WIDTHS}")
    for t in (deltaA, deltaBx, C, h0):
        if t.dtype != torch.float32:
            raise ValueError(f"the scan takes float32 tensors; got {t.dtype}")


def selective_scan(deltaA: torch.Tensor, deltaBx: torch.Tensor,
                   C: torch.Tensor, h0: torch.Tensor):
    """-> (y [B, S, di], h_final [B, di, N]).  CUDA tensors: one K8
    launch; CPU tensors: the plain recurrence."""
    if deltaA.device.type == "cpu":
        _check(deltaA, deltaBx, C, h0)
        return selective_scan_ref(deltaA, deltaBx, C, h0)
    return selective_scan_launch(deltaA, deltaBx, C, h0)


def selective_scan_launch(deltaA, deltaBx, C, h0):
    """K8's wrapper: checked operands -> (y, h_final), one launch on the
    current stream."""
    _check(deltaA, deltaBx, C, h0)
    for t in (deltaA, deltaBx, C, h0):
        if t.device.type != "cuda" or t.device != deltaA.device:
            raise ValueError("selective_scan_launch runs CUDA tensors of one "
                             f"device; got {t.device} beside {deltaA.device}")
        if not t.is_contiguous():
            raise ValueError("selective_scan_launch takes contiguous tensors")
    B, S, di, _ = deltaA.shape
    y = torch.empty((B, S, di), dtype=torch.float32, device=deltaA.device)
    h = torch.empty_like(h0)
    _ext.extension().selective_scan(deltaA, deltaBx, C, h0, y, h)
    _ext.count_launch("selective_scan")
    return y, h
