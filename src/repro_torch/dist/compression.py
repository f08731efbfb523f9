"""Gradient compression: blockwise symmetric int8 all-reduce (counterpart
of ``repro.dist.compression``).

Wire format: the flat tensor is split into 128-element blocks; each block
is quantized symmetrically to int8 with one f32 scale (max|block| / 127).
An all-reduce then ships int8 payload + f32 scales (all-gather + local
sum) instead of bf16 ring chunks — >1.5x fewer wire bytes on 2+ devices,
with a quantization error bounded by scale/2 per element.

The JAX package computes this outside any Pallas kernel, so these are
plain tensor functions; on the CPU they give the reference's bits (the
same f32 divide, max / 127, max(scale, 1e-12), round half to even).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

BLOCK = 128
_QMAX = 127.0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 -> (int8 [n_blocks, BLOCK], f32 scales [n_blocks])."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / _QMAX
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    """quantize |> dequantize — error <= max|block|/254 per element."""
    q, s = quantize(x)
    return dequantize(q, s, tuple(x.shape))


def wire_bytes(n_params: int, *, group: int = 2) -> dict:
    """Wire bytes per device: compressed all-gather vs bf16 ring all-reduce."""
    blocks = math.ceil(n_params / BLOCK)
    bf16_ring = 2 * 2 * n_params * (group - 1) / group  # reduce- + all-gather
    compressed = (n_params * 1 + blocks * 4) * (group - 1)
    return {
        "bf16_ring_bytes": bf16_ring,
        "compressed_bytes": compressed,
        "ratio": bf16_ring / max(compressed, 1),
    }


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (None: the default
    group), shipping int8 + scales: every rank all-gathers the payloads
    and scales, then sums the dequantized blocks in rank order in f32."""
    q, s = quantize(x)
    n = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(n)]
    sg = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qg, q, group=group)
    dist.all_gather(sg, s, group=group)
    total = qg[0].to(torch.float32) * sg[0][:, None]
    for qr, sr in zip(qg[1:], sg[1:]):
        total = total + qr.to(torch.float32) * sr[:, None]
    return total.reshape(-1)[:math.prod(x.shape)].reshape(x.shape)


def make_compressed_allreduce(mesh, axis: str):
    """-> fn(x): the compressed psum of each rank's ``x`` (its shard)
    over the ranks of ``mesh``'s dim ``axis``."""
    group = mesh.get_group(axis)
    return lambda x: compressed_psum(x, group)
