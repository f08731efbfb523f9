#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s timing phases from several checkouts in
turn, on one card, so that two versions of the port are compared inside
one run.

    python3 tools/compare_checkouts.py path_lm_serve build/parent . . build/parent
    python3 tools/compare_checkouts.py kernels_time build/variant . . build/variant
    python3 tools/compare_checkouts.py mlp_bits,kernels_time_dag build/parent . . build/parent
    python3 tools/compare_checkouts.py kernels_time_lm,kernels_time_scan,path_hybrid_serve build/parent . . build/parent
    python3 tools/compare_checkouts.py kernels_time_mat,kernels_time_bgemm build/parent . . build/parent
    python3 tools/compare_checkouts.py path_lm_serve,path_hybrid_serve,path_moe_serve build/parent . . build/parent

The first argument names the phase, or several joined by commas (run in
one process a checkout, after one build):

- ``path_lm_serve``: Qwen3-1.7B served as the smoke serves it; prints the
  prefill ms per call and the decode ms per step on ``backend="cuda"``
  and on ``backend="interpret"``;
- ``kernels_time``: the one-table flow-ddos batch of ``kernels_time``
  (B = 512, deepest chain 135); prints each kernel's wrapper ms (``ms``,
  CUDA events around 50 back-to-back calls) and device ms
  (``kernel_ms``, the profiler), and the same for K1's other modes;
- ``kernels_time_dag``: the smoke's ``dag_timing`` (K5 and K6 at the AD
  widths, K3, K5 and K6 at full width, at the batch sizes that
  checkout's smoke times); prints each one's ``ms`` and ``kernel_ms``;
- ``mlp_bits``: K3, K5 and K6 on seeded inputs (``MLP_BITS_WIDTHS`` and
  two DAGs at ``MLP_BITS_BATCHES`` rows); prints a SHA-256 of each
  output's bytes, so two checkouts' kernels can be held bit for bit;
- ``path_dag``: the smoke's ``path_dag`` phase; prints the pkt/s of each
  configuration and batch size (median of the passes, and all of them);
- ``kernels_time_lm``: the smoke's K7 timings at this tool's
  ``K7_SHAPES`` (set on each checkout's smoke, so that every checkout
  times the same shapes, f32 at the Qwen3 and Jamba shapes included);
  prints each shape's ``ms``, ``kernel_ms`` (summed over the call's
  kernels), the kernels' names and SDPA's device ms;
- ``kernels_time_scan``: the smoke's K8 timings; prints ``ms`` and
  ``kernel_ms`` of every row it emits (the discretizing entry with its
  "before", the eager passes plus the TPU-interface K8, where the
  checkout has it);
- ``path_hybrid_serve``, ``path_moe_serve``: Jamba-1.5-Large, and
  Moonshot-v1-16B-A3B, served as the smoke serves them (bf16, then f32);
  prints each run's prefill ms per call, decode ms per step, tok/s and
  peak GB on ``backend="cuda"``;
- ``kernels_time_mat``: K4 at the mat-fused shape (B = 512) and at the
  Tofino shape of ``path_generate`` (7 features, 512 bins, 2 classes) at
  ``MAT_BATCHES`` rows, on tables and rows made here from seeds (so every
  checkout gets the same); prints each one's wrapper ms (the least of 5
  CUDA-event timings of 100 back-to-back calls), device ms (the
  profiler, every kernel of the call), a SHA-256 of the verdicts, and
  the launch floor: a one-element ``torch.zeros`` fill's wrapper and
  device ms;
- ``kernels_time_bgemm``: K9 on seeded f32 operands at ``BGEMM_SHAPES``;
  prints wrapper ms (as above), device ms (every kernel of the call), a
  SHA-256 of the result and ``torch._int_mm``'s ms on the pre-signed
  operands with the second one row-major and column-major;
- ``telemetry_hooks``: the smoke's flow-ddos fused engine at B = 512
  (``TEL_HOOK_PASSES`` passes of its stream): telemetry off and on in
  turns (``TEL_HOOK_ROUNDS`` rounds: pkt/s, the engine's ``dispatch_s``
  and the pass's whole host time per batch), then every recording site
  timed on a third engine by THIS tree's ``chip_smoke.hook_costs``
  (which wraps only what every version of the engine has), so that the
  sites of two checkouts' engines are timed by one instrument.

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
import time

PHASES = ("path_lm_serve", "kernels_time", "kernels_time_dag", "mlp_bits",
          "path_dag", "kernels_time_lm", "kernels_time_scan",
          "path_hybrid_serve", "path_moe_serve", "kernels_time_mat",
          "kernels_time_bgemm", "telemetry_hooks")
TEL_HOOK_ROUNDS, TEL_HOOK_PASSES = 4, 5
MAT_BATCHES = (1, 1024, 2048, 8192)
BGEMM_SHAPES = ((1024, 128, 128), (4096, 4096, 4096))
# kernels_time_lm's shapes on every checkout: name, B, Sq, Skv, H, K,
# q_offset, dtype (D = 128), as chip_smoke.K7_TIMED
K7_SHAPES = (("prefill_512", 4, 512, 512, 16, 8, 0, "bfloat16"),
             ("decode_511", 4, 1, 1024, 16, 8, 511, "bfloat16"),
             ("jamba_prefill_512", 4, 512, 512, 64, 8, 0, "bfloat16"),
             ("jamba_decode_543", 4, 1, 1024, 64, 8, 543, "bfloat16"),
             ("prefill_512_f32", 4, 512, 512, 16, 8, 0, "float32"),
             ("decode_511_f32", 4, 1, 1024, 16, 8, 511, "float32"),
             ("decode_1023_f32", 4, 1, 1024, 16, 8, 1023, "float32"),
             ("jamba_prefill_512_f32", 4, 512, 512, 64, 8, 0, "float32"),
             ("jamba_decode_543_f32", 4, 1, 1024, 64, 8, 543, "float32"))
MLP_BITS_WIDTHS = ((7,) + (128,) * 10 + (2,), (30,) + (128,) * 10 + (2,),
                   (47,) + (128,) * 10 + (2,), (64, 256, 256, 10),
                   (20,) + (48,) * 15 + (3,), (1, 4, 2), (7, 16, 8, 2),
                   (28, 16, 8, 2))
MLP_BITS_BATCHES = (1, 31, 37, 128, 1024, 4096, 8192)


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


def dag_time_numbers(chip_smoke, dev) -> dict:
    row = run_phase(chip_smoke, "kernels_time_dag",
                    lambda: chip_smoke.dag_timing(dev))
    return {k: {cfg: {"ms": m["ms"], "kernel_ms": m["kernel_ms"]}
                for cfg, m in v.items()}
            for k, v in row.items() if k.startswith("fused_")}


def mlp_bits(chip_smoke, dev) -> dict:
    """K3, K5 and K6 of this checkout on seeded inputs -> {case: SHA-256
    of the output's bytes}."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import he_mlp

    def digest(t) -> str:
        torch.cuda.synchronize()
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    for widths in MLP_BITS_WIDTHS:
        p = fm.pack_params(*he_mlp(widths, seed=len(widths)), device=dev)
        for B in MLP_BITS_BATCHES:
            x = torch.as_tensor(np.random.default_rng(B).normal(
                size=(B, widths[0])).astype(np.float32) * 2, device=dev)
            case = f"{'x'.join(map(str, widths))}@{B}"
            out[f"K5 {case}"] = digest(fm.fused_mlp_launch(x, p))
            out[f"K3 {case}"] = digest(fm.fused_mlp_classify_launch(x, p))
    full, tc, ad = MLP_BITS_WIDTHS[0], (7, 2), (7, 16, 8, 2)
    for name, widths, plan in (
            ("ad_full>tc", (full, tc), ("seq", (("model", 0), ("model", 1)))),
            ("full|full", (full, full), ("or", (("model", 0), ("model", 1)))),
            ("ad>tc", (ad, tc), ("seq", (("model", 0), ("model", 1))))):
        dag = fm.pack_dag([he_mlp(w, seed=11 + i)
                           for i, w in enumerate(widths)], plan, device=dev)
        for B in MLP_BITS_BATCHES:
            x = torch.as_tensor(np.random.default_rng(B).normal(
                size=(B, 7)).astype(np.float32) * 2, device=dev)
            out[f"K6 {name}@{B}"] = digest(fm.fused_dag_launch(x, dag))
    return out


def path_dag_numbers(chip_smoke, dev) -> dict:
    row = run_phase(chip_smoke, "path_dag",
                    lambda: chip_smoke.path_dag_phase(dev))
    return {f"{r['config']} {r['dag']} B={r['max_batch']}":
            {"pkt_per_s": r["pkt_per_s"], "runs": r["pkt_per_s_runs"]}
            for r in row["rows"]}


def lm_kernel_numbers(chip_smoke, dev) -> dict:
    chip_smoke.K7_TIMED = K7_SHAPES
    row = run_phase(chip_smoke, "kernels_time_lm",
                    lambda: chip_smoke.kernels_time_lm(dev))
    return {cfg: {k: m[k] for k in ("ms", "kernel_ms", "kernels",
                                    "library_kernel_ms")}
            for cfg, m in row.items() if isinstance(m, dict) and "ms" in m}


def scan_numbers(chip_smoke, dev) -> dict:
    row = run_phase(chip_smoke, "kernels_time_scan",
                    lambda: chip_smoke.kernels_time_scan(dev))
    out = {}

    def walk(prefix, tree):
        for key, m in tree.items():
            if isinstance(m, dict) and "ms" in m:
                out[prefix + key] = {k: m[k] for k in (
                    "ms", "kernel_ms", "before_kernel_ms") if k in m}
            elif isinstance(m, dict):
                walk(f"{prefix}{key}/", m)

    walk("", row)
    return out


def serve_numbers(phase: str):
    def numbers(chip_smoke, dev) -> dict:
        row = run_phase(chip_smoke, phase,
                        lambda: getattr(chip_smoke, phase)(dev))
        return {run: {k: row[run][k] for k in ("prefill_ms",
                                               "decode_ms_per_step",
                                               "tok_per_s", "peak_gb")}
                for run in ("bf16", "f32")}

    return numbers


def _digest(t) -> str:
    import hashlib

    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def best_ms(chip_smoke, fn, rounds: int = 5, n: int = 100) -> float:
    """A host-bound call's time: the least of ``rounds`` CUDA-event timings
    of n back-to-back calls (the host's noise only ever adds)."""
    return min(chip_smoke.time_ms(fn, n) for _ in range(rounds))


def mat_numbers(chip_smoke, dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import mat_lut as ml
    from repro_torch.testing import mat_stages

    def timed(mat, x) -> dict:
        k4 = lambda: ml.mat_classify_launch(x, mat)  # noqa: E731
        return {"ms": best_ms(chip_smoke, k4),
                "kernel_ms": chip_smoke.call_device_ms(k4),
                "verdicts": _digest(k4())}

    rng = np.random.default_rng(24)
    mst = mat_stages(28)
    fused = ml.pack_mat(mst[0].edges, mst[1].tables, mst[3].table,
                        device=dev)
    x = np.concatenate([rng.integers(1, 12, (512, 1)),
                        rng.random((512, 27)) * 2], 1).astype(np.float32)
    out = {"mat_fused_512": timed(fused, torch.as_tensor(x, device=dev))}
    hi = rng.random(7) * 4 + 1
    edges = np.stack([np.linspace(-h, h, 513)[1:-1] for h in hi]
                     ).astype(np.float32)
    tofino = ml.pack_mat(edges, rng.normal(size=(7, 512, 2)).astype(
        np.float32), device=dev)
    for B in MAT_BATCHES:
        x = (rng.normal(size=(B, 7)) * 2).astype(np.float32)
        out[f"tofino_{B}"] = timed(tofino, torch.as_tensor(x, device=dev))
    fill = lambda: torch.zeros(1, device=dev)  # noqa: E731
    out["launch_floor"] = {"ms": best_ms(chip_smoke, fill),
                           "kernel_ms": chip_smoke.call_device_ms(fill)}
    return out


def bgemm_numbers(chip_smoke, dev) -> dict:
    import torch

    from repro_torch.kernels.binarized_gemm import (
        binarized_gemm_launch,
        sign_pm1,
    )

    out = {}
    for B, K, N in BGEMM_SHAPES:
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((B, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev)
        k9 = lambda: binarized_gemm_launch(x, w)  # noqa: E731
        xs = sign_pm1(x).to(torch.int8)
        ws = sign_pm1(w).to(torch.int8)
        wc = ws.t().contiguous().t()
        out[f"{B}x{K}x{N}"] = {
            "ms": best_ms(chip_smoke, k9),
            "kernel_ms": chip_smoke.call_device_ms(k9),
            "result": _digest(k9()),
            "int_mm_row_major_ms": chip_smoke.time_ms(
                lambda: torch._int_mm(xs, ws), 50),
            "int_mm_column_major_ms": chip_smoke.time_ms(
                lambda: torch._int_mm(xs, wc), 50)}
        del x, w, xs, ws, wc
        torch.cuda.empty_cache()
    return out


def telemetry_hook_numbers(chip_smoke, dev) -> dict:
    """Telemetry off and on in turns, then each recording site, on this
    checkout's engine, timed by this tool's tree's ``hook_costs``."""
    import importlib.util

    import numpy as np

    from repro_torch.data import traffic

    spec = importlib.util.spec_from_file_location(
        "tool_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    tool = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    spec.loader.exec_module(tool)       # it puts its own src/ first: undo
    sys.path[:] = path
    stages = chip_smoke.flow_ddos_stages(chip_smoke.S_KERNEL)
    stream = traffic.make_stream("ddos_burst", n_packets=chip_smoke.N_PACKETS,
                                 seed=chip_smoke.STREAM_SEED)
    engines = {mode: chip_smoke.serve_engine(stages, "cuda", True, 512, dev,
                                             telemetry=tel)
               for mode, tel in (("off", False), ("on", None))}
    out = {m: {"pkt_per_s": [], "dispatch_us": [], "host_us": []}
           for m in engines}
    for eng in engines.values():
        for _ in eng.serve_stream(stream.chunks(512)):
            pass
    for _ in range(TEL_HOOK_ROUNDS):
        for mode, eng in engines.items():
            st = eng.stats_
            p0, w0, b0, d0 = st.packets, st.wall_s, st.batches, st.dispatch_s
            t = time.perf_counter()
            for _ in range(TEL_HOOK_PASSES):
                for _ in eng.serve_stream(stream.chunks(512)):
                    pass
            host = time.perf_counter() - t
            nb = st.batches - b0
            out[mode]["pkt_per_s"].append((st.packets - p0)
                                          / (st.wall_s - w0))
            out[mode]["dispatch_us"].append((st.dispatch_s - d0) / nb * 1e6)
            out[mode]["host_us"].append(host / nb * 1e6)
    out["pair_ratios"] = [a / b for a, b in zip(out["on"]["pkt_per_s"],
                                                out["off"]["pkt_per_s"])]
    out["median_pair_ratio"] = float(np.median(out["pair_ratios"]))
    out["hook_sites"] = tool.hook_costs(
        chip_smoke.serve_engine(stages, "cuda", True, 512, dev),
        lambda: stream.chunks(512), TEL_HOOK_PASSES)
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
    runs = {"path_lm_serve": lm_numbers, "kernels_time": kernel_numbers,
            "kernels_time_dag": dag_time_numbers, "mlp_bits": mlp_bits,
            "path_dag": path_dag_numbers,
            "kernels_time_lm": lm_kernel_numbers,
            "kernels_time_scan": scan_numbers,
            "path_hybrid_serve": serve_numbers("path_hybrid_serve"),
            "path_moe_serve": serve_numbers("path_moe_serve"),
            "kernels_time_mat": mat_numbers,
            "kernels_time_bgemm": bgemm_numbers,
            "telemetry_hooks": telemetry_hook_numbers}
    for name in phase.split(","):
        print(json.dumps({"phase": name, "root": root, "build_s": build_s,
                          "card": chip_smoke.nvidia_smi(),
                          **runs[name](chip_smoke, dev)}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 3 or not set(sys.argv[1].split(",")) <= set(PHASES):
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
