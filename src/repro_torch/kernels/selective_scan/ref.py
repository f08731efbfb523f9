"""Plain PyTorch versions of K8 (counterpart of
``repro.kernels.selective_scan.ref``): the Mamba selective scan as the
naive sequential recurrence,

    h_t = dA_t * h_{t-1} + dBx_t          (elementwise over [di, N])
    y_t = sum_n h_t[:, n] * C_t[n]

``selective_scan_ref`` takes the discretized inputs (the TPU kernel's
interface); ``discretize`` forms them by the reference's expressions
(``repro/models/ssm.py:117-121``) and ``selective_scan_discretized_ref``
chains the two, the plain version of K8's discretizing entry.
``selective_scan_channel_ref`` is the same recurrence in the kernel's
own order: y summed over n in ascending order, every product and sum
rounded apart.  The CPU tests hold them against the reference's oracle
and its chunked associative scan, and ``chip_smoke.py`` holds the
kernel against them on the card."""

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


def discretize(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               x: torch.Tensor):
    """dt [B, S, di] f32, A [di, N], Bm [B, S, N] f32, x [B, S, di] ->
    (dA = exp(dt A), dBx = (dt Bm) x), each [B, S, di, N] f32: the
    reference's expressions, the second operation of each in place."""
    deltaA = (dt[..., None] * A).exp_()
    deltaBx = (dt[..., None] * Bm[:, :, None, :]).mul_(
        x.to(torch.float32)[..., None])
    return deltaA, deltaBx


def selective_scan_discretized_ref(dt, A, Bm, Cm, x, h0):
    """The discretizing entry's plain version: ``discretize``, then
    ``selective_scan_ref`` -> (y [B, S, di], h_final [B, di, N])."""
    return selective_scan_ref(*discretize(dt, A, Bm, x), Cm, h0)


def selective_scan_channel_ref(deltaA: torch.Tensor, deltaBx: torch.Tensor,
                               C: torch.Tensor, h0: torch.Tensor):
    """K8's own order, written out: per channel, h_t[n] = dA h_{t-1}[n] +
    dBx (the product and the sum rounded apart) and y_t = ((h[0] C[0] +
    h[1] C[1]) + h[2] C[2]) + ..., n ascending, each product and sum
    rounded apart.  Same interface as ``selective_scan_ref``."""
    B, S, di, N = deltaA.shape
    h = h0
    ys = []
    for t in range(S):
        h = deltaA[:, t] * h + deltaBx[:, t]
        hc = h * C[:, t, None, :]
        y = hc[..., 0]
        for n in range(1, N):
            y = y + hc[..., n]
        ys.append(y)
    if not ys:
        return deltaA.new_zeros((B, 0, di)), h0.clone()
    return torch.stack(ys, 1), h
