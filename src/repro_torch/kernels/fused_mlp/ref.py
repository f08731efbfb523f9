"""Plain PyTorch versions of the per-packet MLP (counterpart of
``repro.kernels.fused_mlp.ref``): x -> (dense + relu)* -> dense logits,
all in f32, and the classify form with the argmax over the logits."""

from __future__ import annotations

import torch


def mlp_ref(x, weights, biases) -> torch.Tensor:
    """x [B, F]; weights[i] [d_i, d_{i+1}]; biases[i] [d_{i+1}] -> logits."""
    h = x.to(torch.float32)
    L = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w.to(torch.float32) + b.to(torch.float32)
        if i < L - 1:
            h = torch.relu(h)
    return h


def mlp_classify_ref(x, weights, biases) -> torch.Tensor:
    """-> int32 class ids: argmax over the logits, ties to the lowest
    index (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(mlp_ref(x, weights, biases), dim=1).to(torch.int32)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """Gap between the two largest logits per row (inf for one class):
    verdicts may differ only where this is within the logit tolerance."""
    if logits.shape[1] < 2:
        return torch.full((logits.shape[0],), float("inf"),
                          device=logits.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]
