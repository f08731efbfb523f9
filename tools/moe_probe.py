#!/usr/bin/env python3
"""Probe Moonshot-v1-16B-A3B on the card: where two attention engines'
f32 runs part, and where a bf16 decode step's time goes.

    python3 tools/moe_probe.py

Seeded as ``chip_smoke.py``'s ``path_moe_serve`` (``MOE_SEED``, round 1's
four 512-token prompts, round 2's short ones):

1. f32 at ``MOE_F32_LAYERS`` layers: the round-1 prefill through three
   attention engines: ``cuda`` (K7), ``interpret`` (``attention_ref``)
   and ``split`` (the plain path with ``attention_split_ref``, the f32
   prefill kernel's own arithmetic in plain PyTorch: 64-key tiles, an
   online softmax).  For ``cuda`` and ``split`` against ``interpret``,
   per layer (``chip_smoke.routing_divergence``): the largest difference
   of the layer's input against its largest magnitude, the tokens whose
   top-k expert set differs, and the probability gap (k-th against
   k+1-th, in the ``interpret`` run) of those tokens; and the last
   position's logits.  Layer 0's attention on K7 against
   ``attention_ref`` on the same q, k, v.
2. bf16 at full depth: one decode step of the served batch under
   ``torch.profiler``: device and host time by operator.

Prints one JSON line per part.  Imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _ext  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    attention_split_ref,
)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.registry import init_params  # noqa: E402
from repro_torch.serve.steps import init_cache  # noqa: E402


def trace(params, cfg, toks, engine: str, dev) -> dict:
    """``chip_smoke.layer_trace`` of a prefill on one attention engine;
    ``"split"`` is the plain path with ``attention_split_ref`` in place of
    ``attention_ref``."""
    if engine != "split":
        return cs.layer_trace(params, cfg, toks, engine, dev)
    saved = attn.attention_ref
    attn.attention_ref = lambda q, k, v, **kw: attention_split_ref(
        q, k, v, tile=64, **kw)
    try:
        return cs.layer_trace(params, cfg, toks, "interpret", dev)
    finally:
        attn.attention_ref = saved


def layer0_attention(params, cfg, toks, dev) -> dict:
    p = params["layers"][0]["attn"]
    h = cs.block_input(params, cfg, 0, "ln1", toks, dev)
    pos = torch.arange(h.shape[1], device=dev)
    with torch.no_grad():
        q = attn.project_q(p, h, cfg, pos)
        k, v = attn.project_kv(p, h, cfg, pos)
        got = attn.prefill_attention(q, k, v, backend="cuda")
        want = attention_ref(q, k, v, causal=True)
        split = attention_split_ref(q, k, v, causal=True, tile=64)
    return {"k7_vs_ref": float((got - want).abs().max()),
            "k7_vs_split": float((got - split).abs().max()),
            "split_vs_ref": float((split - want).abs().max()),
            "out_max": float(want.abs().max())}


def decode_profile(dev) -> dict:
    full = configs.get_config(cs.MOE_ARCH)
    params = init_params(full, generator=torch.Generator(device=dev)
                         .manual_seed(cs.MOE_SEED), device=dev,
                         dtype=torch.bfloat16)
    reqs = cs.moe_requests(full.vocab_size)[cs.LM_SLOTS:]
    (S, toks, _), = cs.lm_batches(reqs)
    x = torch.as_tensor(toks, device=dev)
    cache = init_cache(full, cs.LM_SLOTS, cs.LM_MAX_SEQ, device=dev)
    kw = dict(caches=cache, logits_slice_last=True, backend="cuda")
    with torch.no_grad():
        tf.forward(params, full, tokens=x[:, :S], mode="prefill", **kw)
        for t in range(2):                                    # warm
            tf.forward(params, full, tokens=x[:, S + t:S + t + 1],
                       mode="decode", index=S + t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.forward(params, full, tokens=x[:, S + 2:S + 3], mode="decode",
                   index=S + 2, **kw)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            tf.forward(params, full, tokens=x[:, S + 3:S + 4],
                       mode="decode", index=S + 3, **kw)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        rows.append({"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_us / 1e3,
                     "host_ms": e.self_cpu_time_total / 1e3})
    by_dev = sorted(rows, key=lambda r: -r["device_ms"])[:20]
    by_host = sorted(rows, key=lambda r: -r["host_ms"])[:20]
    return {"step_ms": step_ms, "by_device": by_dev, "by_host": by_host}


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_probe: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _ext.extension()
    cfg = dataclasses.replace(configs.get_config(cs.MOE_ARCH),
                              num_layers=cs.MOE_F32_LAYERS)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(cs.MOE_SEED), device=dev,
                         dtype=torch.float32)
    reqs = cs.moe_requests(cfg.vocab_size)
    S, toks, _ = cs.lm_batches(reqs)[0]
    x = torch.as_tensor(toks[:, :S], device=dev)
    runs = {e: trace(params, cfg, x, e, dev)
            for e in ("interpret", "cuda", "split")}
    k = cfg.num_experts_per_tok
    print(json.dumps({"part": "f32_prefill_round1",
                      "cuda_vs_interpret": cs.routing_divergence(
                          runs["cuda"], runs["interpret"], k),
                      "split_vs_interpret": cs.routing_divergence(
                          runs["split"], runs["interpret"], k),
                      "layer0_attention": layer0_attention(
                          params, cfg, toks[:, :S], dev),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    del runs, params
    torch.cuda.empty_cache()
    print(json.dumps({"part": "bf16_decode_profile",
                      **decode_profile(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
