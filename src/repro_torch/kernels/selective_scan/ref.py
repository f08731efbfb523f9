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
kernel against them on the card.

K8b, the discretizing entry's gradient, has two plain versions:
``selective_scan_bwd_ref``, the reverse recurrence written out over
whole [B, di, N] steps, and ``selective_scan_bwd_chunked_ref``, K8b's own
schedule (checkpoints every T steps, each chunk recomputed forward from
its checkpoint and walked backward, the sums across channels and batch
in the kernel's fixed order).  With g_t = dL/dh_t = dy_t C_t + dA_{t+1}
g_{t+1} (plus dh_final at the last step), both return

    ddt_t[d] = sum_n g_t h_{t-1} dA_t A[d, n] + (sum_n g_t Bm_t[n]) x_t[d]
    dA[d, n] = sum_{b, t} g_t h_{t-1} dA_t dt_t[d]
    dBm_t[n] = sum_d g_t dt_t[d] x_t[d]
    dCm_t[n] = sum_d dy_t[d] h_t[d, n]
    dx_t[d]  = dt_t[d] sum_n g_t Bm_t[n]           (in x's dtype)
    dh0      = dA_1 g_1"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _ext

# K8b's threads a block; the states a channel keeps for one chunk's walk:
# a chunk of min(SSB_MAX_T, SSB_HIST / N) steps; the states a lane holds
# (a channel's N over N / SSB_LANE_N lanes, all N on one lane below that)
SSB_THREADS = _ext.header_define("SSB_THREADS")
SSB_HIST = _ext.header_define("SSB_HIST")
SSB_MAX_T = _ext.header_define("SSB_MAX_T")
SSB_LANE_N = _ext.header_define("SSB_LANE_N")


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


def bwd_chunk(N: int) -> int:
    """K8b's chunk, the steps between two checkpoints of h at state width
    N."""
    return min(SSB_MAX_T, max(1, SSB_HIST // N))


def bwd_lanes(N: int) -> int:
    """K8b's lanes a channel at state width N (``SSB_LANES``)."""
    return 1 if N < SSB_LANE_N else N // SSB_LANE_N


def bwd_channels(N: int) -> int:
    """K8b's channels a block at state width N (``SSB_CHANNELS``): its
    partial sums over channels are [ceil(di / this), B, S, N]."""
    return SSB_THREADS // bwd_lanes(N)


def scan_checkpoints(dt, A, Bm, x, h0, chunk: int) -> torch.Tensor:
    """h entering each chunk of ``chunk`` steps, [B, ceil(S / chunk), di,
    N] f32 (chunk 0's is h0): the state K8's forward writes under
    autograd, in its order (the discretization's and the step's products
    and sums rounded apart)."""
    B, S, di = dt.shape
    xf = x.to(torch.float32)
    h, out = h0, []
    for t in range(S):
        if t % chunk == 0:
            out.append(h)
        deltaA = (dt[:, t, :, None] * A).exp_()
        deltaBx = (dt[:, t, :, None] * Bm[:, t, None, :]).mul_(
            xf[:, t, :, None])
        h = deltaA * h + deltaBx
    if not out:
        return h0.new_zeros((B, 0, di, A.shape[1]))
    return torch.stack(out, 1)


def selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy, dh_final=None):
    """The gradient of ``selective_scan_discretized_ref`` by the reverse
    recurrence written out: the forward's states kept whole, then one
    backward step over [B, di, N] at a time.  dy [B, S, di] f32 (the
    gradient of y), dh_final [B, di, N] f32 or None (zero) -> (ddt [B,
    S, di], dA [di, N], dBm [B, S, N], dCm [B, S, N] f32, dx [B, S, di]
    in x's dtype, dh0 [B, di, N] f32)."""
    B, S, di = dt.shape
    xf = x.to(torch.float32)
    hs = [h0]
    for t in range(S):
        deltaA = (dt[:, t, :, None] * A).exp_()
        hs.append(deltaA * hs[-1] + (dt[:, t, :, None] * Bm[:, t, None, :])
                  * xf[:, t, :, None])
    g = torch.zeros_like(h0) if dh_final is None else dh_final.clone()
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(xf)
    dBm, dCm = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA = torch.zeros_like(A)
    for t in reversed(range(S)):
        deltaA = (dt[:, t, :, None] * A).exp_()
        g = dy[:, t, :, None] * Cm[:, t, None, :] + g
        q = g * (deltaA * hs[t])
        gb = (g * Bm[:, t, None, :]).sum(-1)
        ddt[:, t] = (q * A).sum(-1) + gb * xf[:, t]
        dx[:, t] = dt[:, t] * gb
        dA += (q * dt[:, t, :, None]).sum(0)
        dBm[:, t] = (g * (dt[:, t] * xf[:, t])[..., None]).sum(1)
        dCm[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        g = deltaA * g
    return ddt, dA, dBm, dCm, dx.to(x.dtype), g


def _block_sums(v: torch.Tensor, nblk: int) -> torch.Tensor:
    """v [B, di, N] -> each block's sum over its ``bwd_channels(N)``
    channels [B, nblk, N] in K8b's order: within a warp (32 / L channels,
    L = ``bwd_lanes(N)`` lanes each) the butterfly's halving tree over the
    channels (16 / L apart first, then 8 / L, ... 1), then the warps in
    order, ((w0 + w1) + w2) + w3; channels past di add nothing."""
    B, di, N = v.shape
    cw = 32 // bwd_lanes(N)
    pad = nblk * bwd_channels(N) - di
    if pad:
        v = torch.cat([v, v.new_zeros((B, pad, N))], 1)
    v = v.reshape(B, nblk, SSB_THREADS // 32, cw, N)
    h = cw
    while h > 1:
        h //= 2
        v = v[:, :, :, :h] + v[:, :, :, h:]
    v = v[:, :, :, 0]
    out = v[:, :, 0]
    for w in range(1, v.shape[2]):
        out = out + v[:, :, w]
    return out


def _lane_sums(v: torch.Tensor) -> torch.Tensor:
    """v [..., N] -> the sum over n in K8b's order: a pairwise tree,
    adjacent pairs first, ((v0 + v1) + (v2 + v3)) + ...: each lane's
    states (``SSB_LANE_N`` of them, in a lane-dependent register order
    that keeps the pairs) and then the channel's ``bwd_lanes(N)`` lanes
    by the butterfly, lanes 1 apart first."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _sum_ascending(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` one term after the other, index ascending."""
    out = v.select(dim, 0)
    for i in range(1, v.shape[dim]):
        out = out + v.select(dim, i)
    return out


def selective_scan_bwd_chunked_ref(dt, A, Bm, Cm, x, h0, dy, dh_final=None):
    """The same gradient in K8b's schedule and order: the forward's
    checkpoints every ``bwd_chunk(N)`` steps (``scan_checkpoints``), the
    chunks last to first, each recomputed forward
    from its checkpoint (dCm's products summed there) and walked backward
    (the rest); the sums over n by ``_lane_sums``, dBm and dCm over a
    block's channels by ``_block_sums``, then over the blocks ascending,
    dA over the steps as walked (last first) and then over the batch
    ascending.  Same interface as ``selective_scan_bwd_ref``."""
    B, S, di = dt.shape
    N = A.shape[1]
    T = bwd_chunk(N)
    nblk = max(1, math.ceil(di / bwd_channels(N)))
    xf = x.to(torch.float32)
    ckpt = scan_checkpoints(dt, A, Bm, x, h0, T)
    carry = torch.zeros_like(h0) if dh_final is None else dh_final.clone()
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(xf)
    dBm_part = Bm.new_zeros((B, S, nblk, N))
    dCm_part = Cm.new_zeros((B, S, nblk, N))
    dA_acc = torch.zeros_like(h0)
    for c in reversed(range(ckpt.shape[1])):
        t0 = c * T
        h, hist = ckpt[:, c], []
        for t in range(t0, min(S, t0 + T)):
            hist.append(h)
            deltaA = (dt[:, t, :, None] * A).exp_()
            h = deltaA * h + (dt[:, t, :, None] * Bm[:, t, None, :]) \
                * xf[:, t, :, None]
            dCm_part[:, t] = _block_sums(dy[:, t, :, None] * h, nblk)
        for t in reversed(range(t0, min(S, t0 + T))):
            deltaA = (dt[:, t, :, None] * A).exp_()
            g = dy[:, t, :, None] * Cm[:, t, None, :] + carry
            q = g * (deltaA * hist[t - t0])
            gb = _lane_sums(g * Bm[:, t, None, :])
            ddt[:, t] = _lane_sums(q * A) + gb * xf[:, t]
            dx[:, t] = dt[:, t] * gb
            dA_acc = dA_acc + q * dt[:, t, :, None]
            dBm_part[:, t] = _block_sums(
                g * (dt[:, t] * xf[:, t])[..., None], nblk)
            carry = deltaA * g
    dBm = _sum_ascending(dBm_part, 2)
    dCm = _sum_ascending(dCm_part, 2)
    dA = _sum_ascending(dA_acc, 0) if B else torch.zeros_like(A)
    return ddt, dA, dBm, dCm, dx.to(x.dtype), carry
