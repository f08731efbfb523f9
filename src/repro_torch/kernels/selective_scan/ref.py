"""Plain PyTorch version of K8 (counterpart of
``repro.kernels.selective_scan.ref``): the Mamba selective scan as the
naive sequential recurrence,

    h_t = dA_t * h_{t-1} + dBx_t          (elementwise over [di, N])
    y_t = sum_n h_t[:, n] * C_t[n]

The CPU tests hold it against the reference's oracle and its chunked
associative scan, and ``chip_smoke.py`` holds the kernel against it on
the card."""

from __future__ import annotations

import torch


def selective_scan_ref(deltaA: torch.Tensor, deltaBx: torch.Tensor,
                       C: torch.Tensor, h0: torch.Tensor):
    """dA, dBx [B, S, di, N], C [B, S, N], h0 [B, di, N], all f32 ->
    (y [B, S, di], h_final [B, di, N])."""
    B, S, di, _ = deltaA.shape
    h = h0
    ys = []
    for t in range(S):
        h = deltaA[:, t] * h + deltaBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    if not ys:
        return deltaA.new_zeros((B, 0, di)), h0.clone()
    return torch.stack(ys, 1), h
