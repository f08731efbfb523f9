"""Serving launcher: batched requests through the ``ServeEngine``
(counterpart of ``repro.launch.serve``).

Runs on the card unless ``--device cpu`` is given; the smoke configs by
default, the published one with ``--full``.  ``--mesh pod`` /
``multipod`` serve on the production mesh as ``launch.train`` trains on
it (every rank runs the engine; ``ServeEngine(mesh=)`` places the
parameters and caches and picks the prefill and decode rules);
``main(mesh=...)`` takes a ``DeviceMesh`` in its place.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --requests 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import launch_mesh
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.step import cast_for_compute, init_train_state


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> list[Request]:
    """The reference launcher's requests: prompts drawn in turn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, cfg.vocab_size, size=prompt_len
                                      ).astype(np.int32),
                    max_new_tokens=max_new)
            for rid in range(n)]


def main(argv=None, *, params=None, requests_out: list | None = None,
         mesh=None) -> dict:
    """Parse ``argv`` and serve.  ``params``: a compute-dtype parameter
    tree (unplaced) to serve in place of the seeded one;
    ``requests_out``: a list the served ``Request``s (their tokens in
    ``.out``) are appended to; ``mesh``: a ``DeviceMesh`` to serve on in
    place of ``--mesh``'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "pod", "multipod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = launch_mesh(args.mesh, mesh, dev)
    if params is None:
        params = cast_for_compute(init_train_state(
            cfg, generator=torch.Generator(dev).manual_seed(args.seed),
            device=dev)["params"])
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_seq=args.max_seq, device=dev, mesh=mesh)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         args.seed)
    for req in reqs:
        engine.submit(req)
    stats = engine.run(max_steps=args.requests * args.max_new + 64)
    if requests_out is not None:
        requests_out.extend(reqs)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
