"""Batched LM serving engine (counterpart of ``repro.serve.engine``).

The reference's lockstep engine, observably the same: up to
``batch_slots`` queued requests are admitted together, left-padded with
token 0 to the longest prompt (no pad mask; positions ``arange(S)``),
prefilled over all ``batch_slots`` rows, and then decoded greedily in
lockstep: each step appends the current token to every request that
wants more and then runs one decode call, ``min(n_new, max_steps)``
calls per batch.  ``run`` returns the reference's stats keys.  The
front ends are the reference's stubs: a vlm prefill gets zero image
embeddings [batch_slots, num_image_tokens, d_model] and an encdec one
zero frames [batch_slots, S, d_model], both bf16.

``backend="cuda"`` (the default) runs attention on K7 and the Mamba
scan on K8, ``"interpret"`` both on the plain versions;
``engine.backend`` reports what served (``"cpu-ref"`` for the kernels'
plain versions on CPU tensors).  ``experts`` names the experts the MoE
layers' parameters hold (a contiguous run of ids, None: all), for a
card that holds a share of them.  ``timing`` holds the prefill and
decode calls and their host-clock seconds, each call ending in the copy
of its tokens to the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import BACKENDS
from repro_torch.models.transformer import decoder_layout
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_seq: int = 128, backend: str = "cuda", device="cuda",
                 experts=None):
        if backend not in BACKENDS:
            raise KeyError(f"backend must be one of {BACKENDS}")
        decoder_layout(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.params = _to_device(params, dev)
        self.max_seq = max_seq
        self.batch = batch_slots
        self.backend = ("cpu-ref" if backend == "cuda" and dev.type == "cpu"
                        else backend)
        self.prefill = make_prefill_step(cfg, backend, experts)
        self.decode = make_decode_step(cfg, backend, experts)
        self.cache = init_cache(cfg, batch_slots, max_seq, device=dev)
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self.tokens_out = 0
        self.timing = {"prefill_calls": 0, "prefill_s": 0.0,
                       "decode_calls": 0, "decode_s": 0.0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        # lockstep engine: admit up to `batch` requests
        while self.queue and len(self.active) < self.batch:
            req = self.queue.pop(0)
            self.active[req.rid] = req

    @torch.no_grad()
    def run(self, max_steps: int = 64) -> dict:
        """Serve queued requests; returns stats."""
        t0 = time.perf_counter()
        served = []
        tm = self.timing
        while (self.queue or self.active) and max_steps > 0:
            self._admit()
            reqs = list(self.active.values())
            S = max(len(r.prompt) for r in reqs)
            toks = np.zeros((self.batch, S), np.int32)
            for i, r in enumerate(reqs):
                toks[i, S - len(r.prompt):] = r.prompt  # left-pad
            batch = {"tokens": torch.as_tensor(toks, device=self.device)}
            if self.cfg.family == "vlm":
                batch["image_embeds"] = torch.zeros(
                    (self.batch, self.cfg.num_image_tokens,
                     self.cfg.d_model), dtype=torch.bfloat16,
                    device=self.device)
            if self.cfg.family == "encdec":
                batch["frames"] = torch.zeros(
                    (self.batch, S, self.cfg.d_model), dtype=torch.bfloat16,
                    device=self.device)
            t = time.perf_counter()
            cur, self.cache = self.prefill(self.params, self.cache, batch)
            host = cur.cpu()
            tm["prefill_calls"] += 1
            tm["prefill_s"] += time.perf_counter() - t
            index = S
            n_new = max(r.max_new_tokens for r in reqs)
            t = time.perf_counter()
            n_steps = min(n_new, max_steps)
            for _ in range(n_steps):
                for i, r in enumerate(reqs):
                    if len(r.out) < r.max_new_tokens:
                        r.out.append(int(host[i]))
                        self.tokens_out += 1
                cur, self.cache = self.decode(
                    self.params, self.cache, cur[:, None], index)
                host = cur.cpu()
                index += 1
                max_steps -= 1
            tm["decode_calls"] += n_steps
            tm["decode_s"] += time.perf_counter() - t
            for r in reqs:
                r.done = True
                served.append(r)
            self.active.clear()
        dt = time.perf_counter() - t0
        return {
            "requests": len(served),
            "tokens": self.tokens_out,
            "wall_s": dt,
            "tok_per_s": self.tokens_out / max(dt, 1e-9),
        }
