"""Serving steps (counterpart of ``repro.serve.steps``): prefill, which
fills the cache (KV, recurrent state, cross-attention memory) and
returns each row's first greedy token, and the one-token decode step.
A prefill batch holds ``tokens`` and, for an encdec config, ``frames``
[B, S, d] or, for a vlm, ``image_embeds`` [B, num_image_tokens, d]."""

from __future__ import annotations

import torch

from repro_torch.common.pytree import materialize
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import forward


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """A zeroed cache tree on ``device``."""
    return materialize(registry.cache_defs(cfg, batch, max_seq),
                       device=resolve_device(device))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The first maximal index, as jnp.argmax."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, backend: str = "cuda",
                      experts=None):
    def prefill_step(params, cache, batch):
        kwargs = {}
        if cfg.family == "encdec":
            kwargs["memory_embeds"] = batch["frames"]
        if cfg.family == "vlm":
            kwargs["memory_embeds"] = batch["image_embeds"]
        logits, new_cache, _ = forward(
            params, cfg, tokens=batch["tokens"], mode="prefill",
            caches=cache, logits_slice_last=True, backend=backend,
            experts=experts, **kwargs)
        return _greedy(logits), new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, backend: str = "cuda",
                     experts=None):
    def decode_step(params, cache, tokens, index: int):
        """tokens [B, 1]; index: the new token's position."""
        logits, new_cache, _ = forward(
            params, cfg, tokens=tokens, mode="decode", index=index,
            caches=cache, logits_slice_last=True, backend=backend,
            experts=experts)
        return _greedy(logits), new_cache

    return decode_step
