"""Losses (counterpart of ``repro.train.losses``): masked cross-entropy
with an f32 logsumexp, the z-loss, and the MoE aux blend, with the
reference's constants and expression order."""

from __future__ import annotations

import torch

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001
Z_LOSS_WEIGHT = 1e-4
IGNORE = -1


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """logits [B, S, V], targets [B, S] (IGNORE = masked).  -> (ce, z,
    acc), f32 scalars."""
    logits = logits.to(torch.float32)
    mask = (targets != IGNORE).to(torch.float32)
    tgt = torch.clamp_min(targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = (lse - true_logit) * mask
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    z = torch.sum(torch.square(lse) * mask) / denom
    acc = torch.sum((torch.argmax(logits, -1) == tgt) * mask) / denom
    return torch.sum(ce) / denom, z, acc


def total_loss(logits: torch.Tensor, targets: torch.Tensor, aux: dict):
    """-> (loss, metrics): ce + Z_LOSS_WEIGHT * z, plus the MoE
    load-balance and router z losses where ``aux`` has them
    (``models.transformer.forward``'s aux)."""
    ce, z, acc = cross_entropy(logits, targets)
    loss = ce + Z_LOSS_WEIGHT * z
    metrics = {"ce": ce, "z_loss": z, "accuracy": acc}
    if "moe_lb_loss" in aux:
        loss = loss + MOE_LB_WEIGHT * aux["moe_lb_loss"]
        loss = loss + MOE_Z_WEIGHT * aux["moe_z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics
