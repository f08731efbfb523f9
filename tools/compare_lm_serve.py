#!/usr/bin/env python3
"""Time ``chip_smoke.path_lm_serve`` from several checkouts in turn, on one
card, so that two versions of the port are compared inside one run.

    python3 tools/compare_lm_serve.py build/parent . . build/parent

Each argument is the root of a checkout that holds ``chip_smoke.py`` and
``src/repro_torch`` (for example the parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists).  Each runs in a
process of its own, builds that checkout's kernels into its own
``build/torch_kernels/`` and serves Qwen3-1.7B as the smoke does; the
script prints one JSON line per run: the root, the build seconds, the
card and the path's prefill ms per call and decode ms per step on
``backend="cuda"`` and on ``backend="interpret"``.  It needs a GPU; hosts
differ between machines, so compare only the lines of one run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> None:
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
    rows = []
    print_ = chip_smoke.emit
    chip_smoke.emit = rows.append
    try:
        chip_smoke.path_lm_serve(torch.device("cuda", 0))
    finally:
        chip_smoke.emit = print_
    row = next(r for r in rows if r.get("phase") == "path_lm_serve")
    print(json.dumps({
        "root": root, "build_s": build_s, "card": chip_smoke.nvidia_smi(),
        "cuda": {k: row[k] for k in ("prefill_ms", "decode_ms_per_step")},
        "interpret": {k: row["interpret"][k]
                      for k in ("prefill_ms", "decode_ms_per_step")}}),
          flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
