"""Public ops: the Mamba selective scan (counterpart of
``repro.kernels.selective_scan.ops``).

Both launch CUDA kernel K8 (``csrc/selective_scan.cu``, one template) for
CUDA tensors and run a plain version for CPU tensors.  There is no other
switch and no fallback.

* ``selective_scan(dA, dBx, C, h0)``: the TPU kernel's interface, the
  discretized inputs dA and dBx [B, S, di, N], C [B, S, N] and h0 [B,
  di, N], all f32 (plain version ``ref.selective_scan_ref``).
* ``selective_scan_discretized(dt, A, Bm, Cm, x, h0)``: dt [B, S, di]
  f32, A [di, N] f32 (already -exp(A_log)), Bm and Cm [B, S, N] f32, x
  [B, S, di] f32 or bf16, h0 [B, di, N] f32; the kernel forms dA =
  exp(dt A) and dBx = (dt Bm) x in registers, in the reference's order,
  so no [B, S, di, N] tensor exists (plain version
  ``ref.selective_scan_discretized_ref``).  The Mamba block's path.

N is a power of two up to 32; both -> (y [B, S, di] f32, h_final [B,
di, N] f32).  Any S works, 1 included: the chunk rule of the Mamba
block (``models.ssm``) is the block's, not the scan's.

Under autograd (grad mode on and an input that requires grad)
``selective_scan_discretized`` runs through ``SelectiveScanFn``: its
forward is K8 with h checkpointed every ``ref.bwd_chunk(N)`` steps
(``selective_scan_ckpt_kernel``, the same launch counted), its backward
K8b (``csrc/selective_scan_bwd.cu``, two launches counted as one
``selective_scan_bwd`` call) on CUDA tensors and
``ref.selective_scan_bwd_ref`` on CPU tensors.  Every other call
launches exactly what it did before and saves nothing.  The TPU
interface ``selective_scan`` has no backward (``_ext.refuse_grad``).

Under a mesh the discretizing entry's operands arrive as ``DTensor``s,
``d_inner`` sharded over "tp" and the batch over "batch" (the
reference's ``models/ssm.py:106``).  The scan is per channel, so
``on_local_channels`` runs it on each rank's local channels and batch
rows, with B and C whole on every rank, and wraps y and h_final back;
the kernel sees plain tensors only.

On ``meta`` tensors (the dry-run's trace) the discretizing entry and its
backward launch nothing: they return outputs of the right shapes and
dtypes and report their work (``scan_cost``) to ``_ext.record_cost``.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import from_local_shard, is_dtensor, local_shard
from repro_torch.kernels import _ext
from repro_torch.kernels.selective_scan.ref import (
    bwd_channels,
    bwd_chunk,
    selective_scan_bwd_ref,
    selective_scan_discretized_ref,
    selective_scan_ref,
)

# the state widths K8 takes (a template parameter)
STATE_WIDTHS = (1, 2, 4, 8, 16, 32)
F32 = torch.float32


def _check_n(N: int) -> None:
    if N not in STATE_WIDTHS:
        raise ValueError(f"state width N={N} is not one K8 takes "
                         f"{STATE_WIDTHS}")


def _check(deltaA, deltaBx, C, h0) -> None:
    if deltaA.dim() != 4 or deltaBx.shape != deltaA.shape:
        raise ValueError("dA and dBx must be one [B, S, di, N] shape; got "
                         f"{tuple(deltaA.shape)}, {tuple(deltaBx.shape)}")
    B, S, di, N = deltaA.shape
    if tuple(C.shape) != (B, S, N) or tuple(h0.shape) != (B, di, N):
        raise ValueError(f"C must be [B, S, N] = {(B, S, N)} and h0 [B, di, "
                         f"N] = {(B, di, N)}; got {tuple(C.shape)}, "
                         f"{tuple(h0.shape)}")
    _check_n(N)
    for t in (deltaA, deltaBx, C, h0):
        if t.dtype != F32:
            raise ValueError(f"the scan takes float32 tensors; got {t.dtype}")


def _check_discretized(dt, A, Bm, Cm, x, h0) -> None:
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError("dt must be [B, S, di] and A [di, N]; got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    B, S, di = dt.shape
    N = A.shape[1]
    want = {"A": (A, (di, N)), "Bm": (Bm, (B, S, N)), "Cm": (Cm, (B, S, N)),
            "x": (x, (B, S, di)), "h0": (h0, (B, di, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} beside dt [B, S, di] = "
                             f"{(B, S, di)} and A [di, N]; got "
                             f"{tuple(t.shape)}")
    _check_n(N)
    for t in (dt, A, Bm, Cm, h0):
        if t.dtype != F32:
            raise ValueError("dt, A, Bm, Cm and h0 must be float32; got "
                             f"{t.dtype}")
    if x.dtype not in (F32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} runs CUDA tensors of one device; got "
                             f"{t.device} beside {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs tensors aligned to 16 bytes")


def selective_scan(deltaA: torch.Tensor, deltaBx: torch.Tensor,
                   C: torch.Tensor, h0: torch.Tensor):
    """-> (y [B, S, di], h_final [B, di, N]).  CUDA tensors: one K8
    launch; CPU tensors: the plain recurrence."""
    if deltaA.device.type == "cpu":
        _check(deltaA, deltaBx, C, h0)
        return selective_scan_ref(deltaA, deltaBx, C, h0)
    return selective_scan_launch(deltaA, deltaBx, C, h0)


def selective_scan_launch(deltaA, deltaBx, C, h0):
    """K8's wrapper, the TPU kernel's interface: checked operands -> (y,
    h_final), one launch on the current stream.  Raises under autograd
    (``_ext.refuse_grad``)."""
    _ext.refuse_grad("selective_scan", (deltaA, deltaBx, C, h0))
    _check(deltaA, deltaBx, C, h0)
    _check_cuda("selective_scan_launch", (deltaA, deltaBx, C, h0))
    B, S, di, _ = deltaA.shape
    y = torch.empty((B, S, di), dtype=F32, device=deltaA.device)
    h = torch.empty_like(h0)
    _ext.extension().selective_scan(deltaA, deltaBx, C, h0, y, h)
    _ext.count_launch("selective_scan")
    return y, h


def selective_scan_discretized(dt: torch.Tensor, A: torch.Tensor,
                               Bm: torch.Tensor, Cm: torch.Tensor,
                               x: torch.Tensor, h0: torch.Tensor):
    """-> (y [B, S, di], h_final [B, di, N]).  CUDA tensors: one K8
    launch that discretizes in registers; CPU tensors: the eager
    discretization, then the plain recurrence.  Under autograd through
    ``SelectiveScanFn`` (K8b or the plain backward).  ``DTensor``
    operands: the same call on each rank's local channels
    (``on_local_channels``)."""
    if any(is_dtensor(t) for t in (dt, A, Bm, Cm, x, h0)):
        return on_local_channels(selective_scan_discretized, dt, A, Bm, Cm,
                                 x, h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, A, Bm, Cm, x, h0)):
        return SelectiveScanFn.apply(dt, A, Bm, Cm, x, h0)
    return _forward(dt, A, Bm, Cm, x, h0)


def on_local_channels(fn, dt, A, Bm, Cm, x, h0):
    """``fn(dt, A, Bm, Cm, x, h0) -> (y, h_final)`` on each rank's local
    shard of ``DTensor`` operands: on each mesh dim that shards dt's
    batch (dim 0) every per-row operand takes that batch shard; on each
    that shards dt's channels (dim 2) dt, x, A, h0 take their channel
    shard and B and C stay whole; every other mesh dim replicates all.
    Gradients of an operand replicated where the call is split are
    partial sums; y is placed as dt, h_final as h0's shard."""
    from torch.distributed.tensor import Replicate, Shard

    d = next(t for t in (dt, A, Bm, Cm, x, h0) if is_dtensor(t))
    mesh = d.device_mesh
    R = Replicate()
    dtp = dt.placements if is_dtensor(dt) else [R] * mesh.ndim
    by = {"dt": [], "A": [], "BC": [], "h": []}
    for p in dtp:
        rows = isinstance(p, Shard) and p.dim == 0
        chans = isinstance(p, Shard) and p.dim == 2
        by["dt"].append(Shard(0) if rows else Shard(2) if chans else R)
        by["A"].append(Shard(0) if chans else R)
        by["BC"].append(Shard(0) if rows else R)
        by["h"].append(Shard(0) if rows else Shard(1) if chans else R)
    split = {i for i, p in enumerate(by["dt"]) if not p.is_replicate()}
    y, h = fn(*(local_shard(t, mesh, by[k], split) for t, k in (
        (dt, "dt"), (A, "A"), (Bm, "BC"), (Cm, "BC"), (x, "dt"),
        (h0, "h"))))
    return (from_local_shard(y, mesh, by["dt"], dt.shape),
            from_local_shard(h, mesh, by["h"], h0.shape))


def scan_cost(dt, A, Bm, x, *, backward: bool = False,
              dh_final: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one discretizing K8 call (``backward``:
    K8b), as the bound column of the port's kernel table counts them: K8
    8 f32 operations per (t, d, n), dt, x and y, B and C, A, h0 and
    h_final once; K8b 21, and its operands and gradients once."""
    B, S, di = dt.shape
    N = A.shape[1]
    xs = x.element_size()
    if backward:
        return 21.0 * B * S * di * N, (
            B * S * di * (12 + 2 * xs) + 16 * B * S * N + 8 * di * N
            + 4 * B * di * N * (3 if dh_final else 2))
    return 8.0 * B * S * di * N, (
        4 * (2 * B * S * di + 2 * B * S * N + di * N + 2 * B * di * N)
        + xs * B * S * di)


def _meta_forward(dt, A, Bm, Cm, x, h0):
    _ext.record_cost("selective_scan_discretized", *scan_cost(dt, A, Bm, x))
    return (torch.empty(dt.shape, dtype=torch.float32, device="meta"),
            torch.empty(h0.shape, dtype=torch.float32, device="meta"))


def _forward(dt, A, Bm, Cm, x, h0):
    if dt.device.type == "meta":
        return _meta_forward(dt, A, Bm, Cm, x, h0)
    if dt.device.type == "cpu":
        _check_discretized(dt, A, Bm, Cm, x, h0)
        return selective_scan_discretized_ref(dt, A, Bm, Cm, x, h0)
    return selective_scan_discretized_launch(dt, A, Bm, Cm, x, h0)


class SelectiveScanFn(torch.autograd.Function):
    """K8's discretizing entry with its gradient: forward K8 writing its
    checkpoints of h (CPU tensors: ``selective_scan_discretized_ref``),
    backward K8b from them (CPU tensors: ``selective_scan_bwd_ref``).  It
    saves the inputs and, on the card, the checkpoints [B, ceil(S / T),
    di, N] f32; dh0 is computed only when h0 requires a gradient."""

    @staticmethod
    def forward(ctx, dt, A, Bm, Cm, x, h0):
        ctx.set_materialize_grads(False)
        ckpt = None
        if dt.device.type in ("cpu", "meta"):
            y, h = _forward(dt, A, Bm, Cm, x, h0)
        else:
            y, h, ckpt = selective_scan_discretized_launch(
                dt, A, Bm, Cm, x, h0, checkpoint=True)
        ctx.save_for_backward(dt, A, Bm, Cm, x, h0, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, A, Bm, Cm, x, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        if dt.device.type == "meta":
            _ext.record_cost("selective_scan_bwd", *scan_cost(
                dt, A, Bm, x, backward=True, dh_final=dh is not None))
            grads = tuple(torch.empty_like(t)
                          for t in (dt, A, Bm, Cm, x, h0))
        elif dt.device.type == "cpu":
            grads = selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy, dh)
        else:
            grads = selective_scan_bwd_launch(
                dt, A, Bm, Cm, x, ckpt, dy, dh,
                need_dh0=ctx.needs_input_grad[5])
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan_discretized_launch(dt, A, Bm, Cm, x, h0, *,
                                      checkpoint: bool = False):
    """K8's wrapper, the discretizing entry: checked operands -> (y,
    h_final), one launch on the current stream; with ``checkpoint`` (the
    forward of ``SelectiveScanFn``) -> (y, h_final, ckpt [B, ceil(S / T),
    di, N]: h entering each chunk of T = ``ref.bwd_chunk(N)`` steps).
    Raises under autograd: its outputs carry no gradient, so a caller
    that trains calls ``selective_scan_discretized``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, A, Bm, Cm, x, h0)):
        raise NotImplementedError(
            "selective_scan_discretized_launch is the bare launch and "
            "carries no gradient: train through selective_scan_discretized, "
            "whose SelectiveScanFn runs K8b in the backward")
    _check_discretized(dt, A, Bm, Cm, x, h0)
    _check_cuda("selective_scan_discretized_launch", (dt, A, Bm, Cm, x, h0))
    y = torch.empty(dt.shape, dtype=F32, device=dt.device)
    h = torch.empty_like(h0)
    B, S, di = dt.shape
    T = bwd_chunk(A.shape[1])
    ckpt = torch.empty((B, -(-S // T), di, A.shape[1]) if checkpoint
                       else (0,), dtype=F32, device=dt.device)
    _ext.extension().selective_scan_discretized(dt, A, Bm, Cm, x, h0, y, h,
                                                ckpt)
    _ext.count_launch("selective_scan_discretized")
    return (y, h, ckpt) if checkpoint else (y, h)


def selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt, dy, dh_final=None, *,
                              need_dh0: bool = False):
    """K8b's wrapper: K8's operands, the checkpoints its forward wrote,
    dy [B, S, di] f32 and dh_final [B, di, N] f32 (None: zero) -> (ddt,
    dA, dBm, dCm, dx in x's dtype, dh0 or None), on the current stream:
    two launches (the walk, the fixed-order sum of its partials) counted
    as one call.  B, S or di of 0 launch nothing."""
    _check_discretized(dt, A, Bm, Cm, x, dt.new_empty(
        (dt.shape[0], dt.shape[2], A.shape[1])))
    B, S, di = dt.shape
    N = A.shape[1]
    T = bwd_chunk(N)
    want = {"ckpt": (ckpt, (B, -(-S // T), di, N)), "dy": (dy, (B, S, di))}
    if dh_final is not None:
        want["dh_final"] = (dh_final, (B, di, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != F32:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    ops = (dt, A, Bm, Cm, x, ckpt, dy) + (
        () if dh_final is None else (dh_final,))
    _check_cuda("selective_scan_bwd_launch", ops)
    new = torch.zeros_like if B * S * di == 0 else torch.empty_like
    grads = (new(dt), new(A), new(Bm), new(Cm), new(x))
    dh0 = None
    if B * S * di == 0:
        if need_dh0:
            dh0 = (torch.zeros((B, di, N), dtype=F32, device=dt.device)
                   if dh_final is None else dh_final.clone())
        return (*grads, dh0)
    dh0 = torch.empty((B, di, N) if need_dh0 else (0,), dtype=F32,
                      device=dt.device)
    nblk = -(-di // bwd_channels(N))
    ws_b = torch.empty(nblk * B * S * N, dtype=F32, device=dt.device)
    ws_c = torch.empty_like(ws_b)
    ws_a = torch.empty(B * di * N, dtype=F32, device=dt.device)
    none = dt.new_empty(0)
    _ext.extension().selective_scan_bwd(
        dt, A, Bm, Cm, x, ckpt, dy, none if dh_final is None else dh_final,
        *grads, dh0, ws_b, ws_c, ws_a)
    _ext.count_launch("selective_scan_bwd")
    return (*grads, dh0 if need_dh0 else None)
