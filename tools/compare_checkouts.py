#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s timing phases from several checkouts in
turn, on one card, so that two versions of the port are compared inside
one run.

    python3 tools/compare_checkouts.py path_lm_serve build/parent . . build/parent
    python3 tools/compare_checkouts.py kernels_time build/variant . . build/variant

The first argument names the phase:

- ``path_lm_serve``: Qwen3-1.7B served as the smoke serves it; prints the
  prefill ms per call and the decode ms per step on ``backend="cuda"``
  and on ``backend="interpret"``;
- ``kernels_time``: the one-table flow-ddos batch of ``kernels_time``
  (B = 512, deepest chain 135); prints each kernel's wrapper ms (``ms``,
  CUDA events around 50 back-to-back calls) and device ms
  (``kernel_ms``, the profiler), and the same for K1's other modes.

Each further argument is the root of a checkout that holds
``chip_smoke.py`` and ``src/repro_torch`` (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each runs in a process of its own, builds that checkout's
kernels into its own ``build/torch_kernels/`` and prints one JSON line:
the root, the build seconds, the card and the phase's numbers.  It needs
a GPU; hosts differ between machines, so compare only the lines of one
run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = ("path_lm_serve", "kernels_time")


def lm_numbers(chip_smoke, dev) -> dict:
    row = run_phase(chip_smoke, "path_lm_serve",
                    lambda: chip_smoke.path_lm_serve(dev))
    return {"cuda": {k: row[k] for k in ("prefill_ms", "decode_ms_per_step")},
            "interpret": {k: row["interpret"][k]
                          for k in ("prefill_ms", "decode_ms_per_step")}}


def kernel_numbers(chip_smoke, dev) -> dict:
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm

    stages = chip_smoke.flow_ddos_stages(chip_smoke.S_KERNEL)
    spec = stages[1].spec
    mlp = fm.pack_params(stages[3].weights, stages[3].biases, device=dev)
    kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
              alpha=spec.ewma_alpha)
    row = run_phase(chip_smoke, "kernels_time", lambda: chip_smoke.timing(
        dev, stages, chip_smoke.table_plan(spec, "all"),
        ff.SuffixPlan("mlp", mlp.num_classes), mlp, kw))
    out = {k: {"ms": v["ms"], "kernel_ms": v["kernel_ms"]}
           for k, v in row.items() if isinstance(v, dict) and "ms" in v}
    out["fused_flow_serve_modes"] = {
        m: {"ms": v["ms"], "kernel_ms": v["kernel_ms"]}
        for m, v in row["fused_flow_serve"]["modes"].items()}
    return out


def run_phase(chip_smoke, phase: str, fn) -> dict:
    """Call ``fn`` with the smoke's ``emit`` caught -> the row it emitted
    for ``phase``."""
    rows = []
    print_ = chip_smoke.emit
    chip_smoke.emit = rows.append
    try:
        fn()
    finally:
        chip_smoke.emit = print_
    return next(r for r in rows if r.get("phase") == phase)


def one(phase: str, root: str) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import time

    import torch

    import chip_smoke
    from repro_torch.kernels import _ext

    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _ext.extension()
    build_s = time.perf_counter() - t
    dev = torch.device("cuda", 0)
    numbers = (lm_numbers if phase == "path_lm_serve"
               else kernel_numbers)(chip_smoke, dev)
    print(json.dumps({"phase": phase, "root": root, "build_s": build_s,
                      "card": chip_smoke.nvidia_smi(), **numbers}),
          flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 3 or sys.argv[1] not in PHASES:
        print(f"usage: {sys.argv[0]} {{{','.join(PHASES)}}} ROOT...",
              file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[2:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", sys.argv[1], root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
