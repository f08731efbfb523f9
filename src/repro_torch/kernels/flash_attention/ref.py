"""Plain PyTorch version of K7 (counterpart of
``repro.kernels.flash_attention.ref``): naive full-matrix softmax
attention with causal masking, a sliding window, GQA (H % K == 0) and a
q position offset.  The CPU tests hold it against the reference, and
``chip_smoke.py`` holds the kernel against it on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, K, D] -> [B, Sq, H, D] in q's dtype,
    computed in f32."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    s = s / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
