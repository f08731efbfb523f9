"""Public op: per-packet MLP + argmax (counterpart of the
``_classify_kernel`` half of ``repro.kernels.fused_mlp``).

``fused_mlp_classify`` launches CUDA kernel K3 (``csrc/fused_mlp.cu``)
for CUDA tensors and runs ``ref.mlp_classify_ref`` for CPU tensors.

Packing: the kernel keeps the whole model in shared memory, so the
weights are packed back to back at their true widths (``pack_params``) —
no lane padding.  Envelope on the H100: layer widths up to
``MAX_MLP_WIDTH``, at most ``MAX_LAYERS`` layers, and weights + biases up
to ``MAX_PARAM_BYTES`` (the rest of a block's 227 KB of shared memory
holds each warp's two activation rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.fused_mlp.ref import mlp_classify_ref

MAX_MLP_WIDTH = 256
MAX_LAYERS = 16
MAX_PARAM_BYTES = 160 * 1024


class PackedMLP(NamedTuple):
    """An MLP packed for the kernels: row-major [d_in, d_out] weights and
    the biases of every layer, concatenated in layer order."""

    w_flat: torch.Tensor     # [sum d_in*d_out] f32
    b_flat: torch.Tensor     # [sum d_out] f32
    widths: tuple            # (d_0, d_1, ..., d_L)

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    @property
    def num_classes(self) -> int:
        return self.widths[-1]

    def layers(self):
        """-> (weights, biases) lists of views (the plain versions' form)."""
        ws, bs, wo, bo = [], [], 0, 0
        for d_in, d_out in zip(self.widths[:-1], self.widths[1:]):
            ws.append(self.w_flat[wo:wo + d_in * d_out].view(d_in, d_out))
            bs.append(self.b_flat[bo:bo + d_out])
            wo += d_in * d_out
            bo += d_out
        return ws, bs


def mlp_envelope_reason(widths) -> str | None:
    """Why an MLP of these widths is outside the kernels' envelope."""
    widths = [int(w) for w in widths]
    if max(widths) > MAX_MLP_WIDTH:
        return f"classifier width {max(widths)} > {MAX_MLP_WIDTH}"
    if len(widths) - 1 > MAX_LAYERS:
        return f"classifier has {len(widths) - 1} layers > {MAX_LAYERS}"
    n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    if n_params * 4 > MAX_PARAM_BYTES:
        return (f"classifier parameters {n_params * 4} B exceed "
                f"{MAX_PARAM_BYTES} B of shared memory")
    return None


def pack_params(weights, biases, device=None) -> PackedMLP:
    """weights[i] [d_i, d_{i+1}], biases[i] [d_{i+1}] (tensors or numpy)
    -> ``PackedMLP`` on ``device`` (default: the first weight's)."""
    ws = [torch.as_tensor(w, dtype=torch.float32) for w in weights]
    bs = [torch.as_tensor(b, dtype=torch.float32) for b in biases]
    dev = device if device is not None else ws[0].device
    widths = (int(ws[0].shape[0]),) + tuple(int(w.shape[1]) for w in ws)
    for w, b, d_in, d_out in zip(ws, bs, widths[:-1], widths[1:]):
        if tuple(w.shape) != (d_in, d_out) or tuple(b.shape) != (d_out,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)} do not chain at {d_in}")
    w_flat = torch.cat([w.reshape(-1) for w in ws]).to(dev).contiguous()
    b_flat = torch.cat(bs).to(dev).contiguous()
    return PackedMLP(w_flat, b_flat, widths)


def check_mlp(mlp: PackedMLP, device) -> None:
    reason = mlp_envelope_reason(mlp.widths)
    if reason is not None:
        raise ValueError(f"outside the MLP-kernel envelope: {reason}")
    for t in (mlp.w_flat, mlp.b_flat):
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("packed MLP must be contiguous f32 on "
                             f"{device}, got {t.dtype} on {t.device}")


def fused_mlp_classify_launch(x: torch.Tensor, mlp: PackedMLP):
    """K3's wrapper: x [B, d_0] f32 contiguous CUDA -> [B] int32 ids, one
    launch on the current stream."""
    check_mlp(mlp, x.device)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 2 or x.shape[1] != mlp.widths[0] \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 [B, {mlp.widths[0]}] "
                         f"on CUDA, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    _ext.extension().fused_mlp_classify(x, mlp.w_flat, mlp.b_flat,
                                        list(mlp.widths), out)
    _ext.count_launch("fused_mlp_classify")
    return out


def fused_mlp_classify_packed(x: torch.Tensor, mlp: PackedMLP):
    """x [B, F] -> class ids [B] int32 for a pre-packed model."""
    if x.device.type == "cpu":
        ws, bs = mlp.layers()
        return mlp_classify_ref(x, ws, bs)
    return fused_mlp_classify_launch(x.to(torch.float32).contiguous(), mlp)


def fused_mlp_classify(x: torch.Tensor, weights, biases):
    """x [B, F] -> class ids [B] int32, argmax fused into the kernel."""
    return fused_mlp_classify_packed(
        x, pack_params(weights, biases, device=x.device))
