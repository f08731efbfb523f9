#!/usr/bin/env python3
"""What the bf16 silu costs a decode step on the card.

    python3 tools/silu_cost.py

``models.layers.silu`` evaluates a bf16 silu as the reference does, x *
(1 / (1 + exp(-x))) with every op rounded in bf16: five eager ops where
torch's fused ``F.silu`` is one (outside autograd in place on one
buffer).  Decode is host-bound eager dispatch, so the cost is the
host's.  This tool prints, on one card:

1. per call, at the decode shapes of the served models (4 slots, one
   token: Qwen3-1.7B's d_ff 6,144, Jamba-1.5-Large's d_inner 16,384 and
   d_ff 24,576, Moonshot's expert width 1,408 over 2 x 4 routed rows)
   and at one prefill shape (4 x 512 x 6,144): the ms of ``F.silu``, of
   ``layers.silu`` as serving calls it (no grad: in place) and of its
   five ops out of place, as training's autograd takes them (the least
   of ``ROUNDS`` CUDA-event timings of ``CALLS`` back-to-back calls; the
   host's noise only ever adds), with a check that the two bf16 forms
   give the same bits;
2. the silu calls of one forward of each served path's layer layout
   (the smoke widths at the served depth, on the CPU: the count depends
   on the layout only): Qwen3-1.7B 28 layers, Jamba-1.5-Large one
   8-layer period, Moonshot-v1-16B-A3B 48 layers;
3. the estimated ms added to a decode step: calls x (the serving
   silu's ms - the fused silu's ms) at the path's widest decode shape.

Prints one JSON line.  Imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS, CALLS = 5, 1000
SHAPES = {"qwen3_decode_ffn": (4, 1, 6144),
          "jamba_decode_mixer": (4, 1, 16384),
          "jamba_decode_ffn": (4, 1, 24576),
          "moonshot_decode_expert": (8, 1, 1408),
          "qwen3_prefill_ffn": (4, 512, 6144)}
# path -> (arch, served depth, the decode shape its widest silu takes)
PATHS = {"path_lm_serve": ("qwen3-1.7b", 28, "qwen3_decode_ffn"),
         "path_hybrid_serve": ("jamba-1.5-large-398b", 8,
                               "jamba_decode_ffn"),
         "path_moe_serve": ("moonshot-v1-16b-a3b", 48,
                            "moonshot_decode_expert")}


def out_of_place(x: torch.Tensor) -> torch.Tensor:
    return x * torch.reciprocal(1 + torch.exp(-x))


def silu_calls(arch: str, layers: int) -> int:
    """layers.silu's calls in one forward of ``arch``'s layout at
    ``layers`` layers (smoke widths, CPU, backend="interpret")."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe, ssm, xlstm
    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import forward

    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.bfloat16)
    n = [0]
    real = L.silu

    def counted(x):
        n[0] += 1
        return real(x)

    mods = (L, moe, ssm, xlstm)
    for m in mods:
        m.silu = counted
    try:
        with torch.no_grad():
            forward(params, cfg, tokens=torch.zeros((1, 2), dtype=torch.int32),
                    mode="train", backend="interpret")
    finally:
        for m in mods:
            m.silu = real
    return n[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.models.layers import silu

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    per_call = {}
    for name, shape in SHAPES.items():
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            same = torch.equal(silu(x), out_of_place(x))
            per_call[name] = {
                form: min(cs.time_ms(lambda: fn(x), CALLS)
                          for _ in range(ROUNDS))
                for form, fn in (("fused_ms", F.silu), ("silu_ms", silu),
                                 ("out_of_place_ms", out_of_place))}
        per_call[name]["same_bits"] = same
    paths = {}
    for path, (arch, layers, shape) in PATHS.items():
        calls = silu_calls(arch, layers)
        row = per_call[shape]
        paths[path] = {"arch": arch, "layers": layers, "silu_calls": calls,
                       "at": shape,
                       "added_ms": calls * (row["silu_ms"] - row["fused_ms"]),
                       "added_ms_out_of_place": calls * (
                           row["out_of_place_ms"] - row["fused_ms"])}
    print(json.dumps({"per_call": per_call, "paths": paths,
                      "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
