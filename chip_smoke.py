#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
``build/torch_kernels/``), then drives the flow-ddos stateful serving
path on the card and checks it, printing one JSON line per phase:

  1. device and build: ``nvidia-smi`` name / power limit, build seconds;
  2. kernels: K1 ``fused_flow_serve``, K2 ``flow_update`` and K3
     ``fused_mlp_classify`` against their plain PyTorch versions on the
     card, on the seeded collision patterns of ``repro_torch.testing`` at
     B=512 with 2,048 slots and in each of K1's readout modes ("all",
     "hist", "raw"; state exact, verdicts under the margin rule), and
     each kernel's time per launch over 50 back-to-back launches (CUDA
     events) and its device time (torch.profiler) on a flow-ddos batch,
     beside its plain version and its bound;
  3. the path at flow-ddos's full size (2,048 slots, W=28, MLP
     [28, 16, 8, 2] with seeded weights, a 16,000-packet ddos_burst
     stream, seed 1): ``PacketServeEngine(backend="cuda", depth=2)`` at
     max_batch 256 and 512, fused and split, held against
     ``backend="interpret"`` and the plain whole-stream walk on the card;
     pkt/s and p50/p99 batch latency per configuration.  Launch counts
     are set to 0 just before and read just after the cuda runs;
  4. the largest table the envelope admits (65,536 slots), max_batch
     512, fused, same checks;
  5. where the time goes on the fused path: device busy time (profiler)
     against the serving wall time, launches per batch, top host ops.

Then it prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check,
a missing GPU or a missing ``src/repro_torch`` exits non-zero without
the ``ok`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
# (non-tensor-core) FLOP/s — the denominators of each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

B_KERNEL, S_KERNEL = 512, 2048
N_PACKETS, STREAM_SEED, MLP_WIDTHS = 16_000, 1, (28, 16, 8, 2)
TIMED_LAUNCHES = 50


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


# ------------------------------------------------------------ helpers


def flow_ddos_stages(n_slots: int):
    from repro_torch.core import stageir
    from repro_torch.data import traffic
    from repro_torch.testing import random_mlp

    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=n_slots)
    w, b = random_mlp(MLP_WIDTHS, seed=0)
    return [fk, ru, ws, stageir.FusedMLP(w, b), stageir.Reduce("argmax")]


def time_ms(fn, n: int) -> float:
    """Time per call of ``fn()``: CUDA events around n back-to-back calls
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def kernel_device_ms(calls: dict, n: int = 20) -> dict:
    """Device time per call of each named CUDA kernel, from one
    torch.profiler session: ``calls`` maps a kernel name to the function
    that launches it.  A kernel the profiler saw no device time for maps
    to None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    out = {}
    for kernel in calls:
        us = sum(getattr(e, "device_time_total", 0.0) for e in avg
                 if kernel in e.key)
        out[kernel] = us / n / 1e3 if us else None
    return out


def max_abs(a, b) -> float:
    import torch

    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()
                 ) if a.numel() else 0.0


def verdict_err(v, logits) -> float:
    """Largest |verdict - reference argmax| over rows outside the margin;
    fails when any such row differs."""
    import numpy as np

    from repro_torch.testing import MARGIN, verdict_mismatches

    v = v.cpu().numpy()
    lg = logits.cpu().numpy()
    bad, _ = verdict_mismatches(v, lg)
    top = np.sort(lg, 1)
    far = (top[:, -1] - top[:, -2]) > MARGIN
    err = np.abs(v.astype(np.int64) - np.argmax(lg, 1))[far]
    check(bad == 0, f"{bad} verdicts differ outside the margin")
    return float(err.max()) if err.size else 0.0


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -------------------------------------------------------------- phase 2


def table_plan(spec, mode: str):
    from repro_torch.kernels import fused_flow as ff

    return ff.TablePlan(spec.n_counters, spec.n_ewma, len(spec.hist_sizes),
                        spec.ewma_alpha, spec.width, mode)


def kernel_phase(dev):
    """K1/K2/K3 against their plain versions on the card: the flow-ddos
    table and MLP on every collision pattern, K1's "hist" and "raw"
    readouts (WindowStats(mode="hist") and no WindowStats) with MLPs of
    their input widths, then a 246-word row with a [246, 64, 4] MLP (eight
    columns per lane; over 48 KB of shared memory, so the kernels' opt-in
    path runs)."""
    from repro_torch.flowstate.registers import FlowStateSpec
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import PATTERNS, random_mlp

    stages = flow_ddos_stages(S_KERNEL)
    spec = stages[1].spec
    mlp = fm.pack_params(stages[3].weights, stages[3].biases, device=dev)
    wide = FlowStateSpec(n_slots=S_KERNEL, n_counters=3, n_ewma=3,
                         hist_sizes=(100, 90, 50), ewma_alpha=0.5)

    def seeded_mlp(sp_, mode, hidden, classes, seed):
        widths = (table_plan(sp_, mode).n_out, *hidden, classes)
        return fm.pack_params(*random_mlp(widths, seed=seed), device=dev)

    wide_mlp = seeded_mlp(wide, "all", (64,), 4, 3)
    hist_mlp = seeded_mlp(spec, "hist", (16, 8), 2, 4)
    raw_mlp = seeded_mlp(spec, "raw", (16, 8), 2, 5)
    wide_hist_mlp = seeded_mlp(wide, "hist", (64,), 4, 6)
    err = {"flow_update": 0.0, "fused_flow_serve": 0.0,
           "fused_mlp_classify": 0.0}
    cases = ([(spec, "all", mlp, p, False) for p in PATTERNS]
             + [(spec, "all", mlp, "one_hot_flow", True),
                (spec, "all", mlp, "mixed", True)]
             + [(spec, "hist", hist_mlp, p, r) for p, r in (
                 ("mixed", True), ("one_hot_flow", False),
                 ("same_slot", False))]
             + [(spec, "raw", raw_mlp, p, r) for p, r in (
                 ("mixed", True), ("same_slot", False))]
             + [(wide, "all", wide_mlp, p, r) for p, r in (
                 ("mixed", True), ("one_hot_flow", False),
                 ("same_slot", False))]
             + [(wide, "hist", wide_hist_mlp, "mixed", True)])
    for i, (sp_, mode, mlp_, pattern, ragged) in enumerate(cases):
        for k, e in check_kernels(dev, sp_, mode, mlp_, pattern, ragged,
                                  seed=100 + i).items():
            err[k] = max(err[k], e)
    emit({"phase": "kernels_check", "cases": len(cases), "B": B_KERNEL,
          "n_slots": S_KERNEL, "widths": [spec.width, wide.width],
          "modes": sorted({c[1] for c in cases}), "max_abs_err": err})
    kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
              alpha=spec.ewma_alpha)
    return err, timing(dev, stages, table_plan(spec, "all"),
                       ff.SuffixPlan("mlp", mlp.num_classes), mlp, kw)


def check_kernels(dev, spec, mode: str, mlp, pattern: str, ragged: bool,
                  seed: int):
    """One batch through K2, K1 (readout ``mode``) and K3 and their plain
    versions, against a table a previous batch of the same pattern left
    -> max abs error per kernel (raises on any disagreement)."""
    import torch

    from repro_torch.kernels import flow_update as fu
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import flow_batch

    tp = table_plan(spec, mode)
    sp = ff.SuffixPlan("mlp", mlp.num_classes)
    kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
              alpha=spec.ewma_alpha)

    def batch(s, r):
        return {k: torch.as_tensor(v, device=dev) for k, v in flow_batch(
            spec, pattern, B_KERNEL, seed=s, ragged=r).items()}

    t, t0 = batch(seed, ragged), batch(seed + 1000, False)
    empty = (torch.full((spec.n_slots,), -1, dtype=torch.int32, device=dev),
             torch.zeros((spec.n_slots, spec.width), device=dev))
    # a table the batch partly continues and partly evicts
    keys, regs, _ = fu.flow_update_ref(*empty, t0["pkt_keys"], t0["upd"],
                                       t0["bins"], t0["valid"], **kw)
    ops = (keys, regs, t["pkt_keys"], t["upd"], t["bins"], t["valid"])
    rk, rr, rf = fu.flow_update_ref(*ops, **kw)
    z = ff.suffix_readout(rf, tp)
    logits = ff.ref.suffix_logits(z, mlp)
    name = f"{pattern} W={spec.width} mode={mode}"

    def bits(x):
        return x.view(torch.int32)

    # the ops update the table they are given in place: give them copies
    k2, r2, f2 = fu.flow_update(keys.clone(), regs.clone(), *ops[2:], **kw)
    torch.cuda.synchronize()
    check(torch.equal(k2, rk) and torch.equal(bits(r2), bits(rr))
          and torch.equal(bits(f2), bits(rf)), f"K2 differs on {name}")
    k1, r1, v1 = ff.fused_flow_serve(keys.clone(), regs.clone(), *ops[2:],
                                     tp, sp, mlp)
    torch.cuda.synchronize()
    check(torch.equal(k1, rk) and torch.equal(bits(r1), bits(rr)),
          f"K1 state differs on {name}")
    v3 = fm.fused_mlp_classify_packed(z.contiguous(), mlp)
    torch.cuda.synchronize()
    return {
        "flow_update": max(max_abs(r2, rr), max_abs(f2, rf),
                           max_abs(k2, rk)),
        "fused_flow_serve": max(verdict_err(v1, logits), max_abs(r1, rr),
                                max_abs(k1, rk)),
        "fused_mlp_classify": verdict_err(v3, logits),
    }


def timing(dev, stages, tp, sp, mlp, kw):
    """Each kernel's wrapper and its plain version on one flow-ddos batch
    (the stream's packets 4096..4607 against the table the first 4096
    packets leave).  The timed K1/K2 launches update one copy of that
    table in place, each applying the same batch again: the same
    segments and chains every launch."""
    import torch

    from repro_torch.data import traffic
    from repro_torch.flowstate.registers import init_state
    from repro_torch.kernels import flow_update as fu
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm

    fk, ru = stages[:2]
    spec = ru.spec
    pk = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                             seed=STREAM_SEED).packets
    st = init_state(spec, dev)
    keys, regs = st.keys, st.regs
    lo = 4096
    for s in range(0, lo, B_KERNEL):
        x = torch.as_tensor(pk[s:s + B_KERNEL], device=dev)
        upd, bins = ru.prepare(x)
        keys, regs, _ = fu.flow_update(
            keys, regs, fk.apply_keys(x), upd, bins,
            torch.ones(B_KERNEL, dtype=torch.int32, device=dev), **kw)
    x = torch.as_tensor(pk[lo:lo + B_KERNEL], device=dev)
    upd, bins = ru.prepare(x)
    valid = torch.ones(B_KERNEL, dtype=torch.int32, device=dev)
    *ops, seg = fu.ops.prepare_operands(keys, regs, fk.apply_keys(x), upd,
                                        bins, valid)
    _, _, feats = fu.flow_update_ref(*ops, **kw)
    z = ff.suffix_readout(feats, tp).contiguous()
    ws, bs = mlp.layers()

    S, W = regs.shape
    B = B_KERNEL
    live = int(valid.sum())
    H = ops[4].shape[1]
    U = ops[3].shape[1]
    n_seg = int((seg.seg_len > 0).sum())
    # bytes the kernels must move for this batch: each touched row and its
    # key read once and written once; pkt_keys, upd, bins and order of the
    # live rows; valid and seg_len of every row; seg_first and seg_slot of
    # the live segments
    rows = 2 * n_seg * (W + 1) * 4
    batch = live * (4 + U * 4 + H * 4 + 4) + B * 4 * 2 + n_seg * 4 * 2
    params = (mlp.w_flat.numel() + mlp.b_flat.numel()) * 4
    mlp_flops = 2 * sum(a * b for a, b in zip(mlp.widths[:-1],
                                              mlp.widths[1:]))
    upd_flops = live * (W * (1 + H) + 3 * tp.n_ewma)
    chain = int(seg.seg_len.max())
    shapes = {"B": B, "n_slots": S, "W": W, "max_chain": chain,
              "segments": n_seg}
    table = ops[0].clone(), ops[1].clone()
    k1 = lambda: ff.fused_flow_serve_launch(*table, *ops[2:], seg, tp, sp,
                                            mlp)
    k2 = lambda: fu.flow_update_launch(*table, *ops[2:], seg, **kw)
    k3 = lambda: fm.fused_mlp_classify_launch(z, mlp)
    dev_ms = kernel_device_ms({"fused_flow_kernel": k1,
                               "flow_update_kernel": k2,
                               "fused_mlp_kernel": k3})
    out = {}
    out["fused_flow_serve"] = dict(
        ms=time_ms(k1, TIMED_LAUNCHES),
        kernel_ms=dev_ms["fused_flow_kernel"],
        plain_ms=time_ms(lambda: ff.fused_flow_serve_ref(*ops, tp, sp, mlp),
                         3),
        bound=bound(rows + batch + params + B * 4,
                    upd_flops + live * (mlp_flops + W)), **shapes)
    out["flow_update"] = dict(
        ms=time_ms(k2, TIMED_LAUNCHES),
        kernel_ms=dev_ms["flow_update_kernel"],
        plain_ms=time_ms(lambda: fu.flow_update_ref(*ops, **kw), 3),
        bound=bound(rows + batch + B * W * 4, upd_flops), **shapes)
    out["fused_mlp_classify"] = dict(
        ms=time_ms(k3, TIMED_LAUNCHES),
        kernel_ms=dev_ms["fused_mlp_kernel"],
        plain_ms=time_ms(lambda: fm.mlp_classify_ref(z, ws, bs),
                         TIMED_LAUNCHES),
        bound=bound(B * z.shape[1] * 4 + params + B * 4, B * mlp_flops),
        B=B, widths=list(mlp.widths))
    emit({"phase": "kernels_time", **{
        k: {kk: vv for kk, vv in v.items()} for k, v in out.items()}})
    return out


# ---------------------------------------------------------- phases 3, 4


def path_phase(dev, name: str, n_slots: int, batches, fuses, n_packets,
               repeats: int = 5):
    """Serve the stream on backend="cuda" for each (max_batch, fuse),
    held against backend="interpret" and the plain walk on the card."""
    import numpy as np
    import torch

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.kernels import _ext
    from repro_torch.serve.packet_engine import PacketServeEngine
    from repro_torch.testing import plain_stream, verdict_mismatches

    stages = flow_ddos_stages(n_slots)
    stream = traffic.make_stream("ddos_burst", n_packets=n_packets,
                                 seed=STREAM_SEED)
    t = time.perf_counter()
    keys, regs, logits = plain_stream(stages, stream.packets, max(batches),
                                      dev)
    plain_s = time.perf_counter() - t

    def serve(backend, fuse, max_batch):
        # entry points get the device as a user names it ("cuda")
        pipe = StatefulPipeline(stages, backend=backend, fuse=fuse,
                                device=dev.type)
        eng = PacketServeEngine(pipe, feature_dim=len(traffic.COLUMNS),
                                max_batch=max_batch, depth=2,
                                device=dev.type)
        v = np.concatenate(list(eng.serve_stream(
            stream.chunks(max_batch))))
        k = eng.state.keys.cpu().numpy()
        r = eng.state.regs.cpu().numpy()
        check(np.array_equal(k, keys) and np.array_equal(
            r.view(np.int32), regs.view(np.int32)),
            f"{name}: {eng.backend} final state differs from the plain walk")
        bad, close = verdict_mismatches(v, logits)
        check(bad == 0, f"{name}: {eng.backend} {bad} verdicts differ")
        return eng, close

    _ext.reset_launches()
    ieng, _ = serve("interpret", True, max(batches))
    check(sum(_ext.LAUNCHES.values()) == 0,
          "the interpret backend launched a kernel")
    rows = [{"backend": ieng.backend, "max_batch": max(batches),
             "pkt_per_s": ieng.stats()["pkt_per_s"]}]

    _ext.reset_launches()
    n_fused = n_split = 0
    for max_batch in batches:
        for fuse in fuses:
            runs = []
            for _ in range(repeats):
                eng, close = serve("cuda", fuse, max_batch)
                runs.append(eng.stats())
                n = eng.stats()["batches"] + 1     # + the warm-up batch
                n_fused, n_split = ((n_fused + n, n_split) if fuse
                                    else (n_fused, n_split + n))
            want = ("cuda" if dev.type == "cuda" else "cpu-ref") \
                + ("-fused-flow" if fuse else "")
            check(all(r["backend"] == want for r in runs),
                  f"{name}: backend {runs[0]['backend']} != {want}")
            pps = sorted(r["pkt_per_s"] for r in runs)
            med = sorted(runs, key=lambda r: r["pkt_per_s"])[len(runs) // 2]
            rows.append({"backend": want, "max_batch": max_batch,
                         "depth": 2, "pkt_per_s": med["pkt_per_s"],
                         "pkt_per_s_runs": pps,
                         "lat_p50_ms": med["lat_p50_ms"],
                         "lat_p99_ms": med["lat_p99_ms"],
                         "dispatch_s": med["dispatch_s"],
                         "wall_s": med["wall_s"],
                         "batches": med["batches"],
                         "margin_rows": close})
    launches = dict(_ext.LAUNCHES)
    torch.cuda.synchronize()
    # one K1 launch per fused batch; one K2 + one K3 per split batch
    check(launches == {"fused_flow_serve": n_fused, "flow_update": n_split,
                       "fused_mlp_classify": n_split},
          f"{name}: launches {launches} != batches "
          f"(fused {n_fused}, split {n_split})")
    emit({"phase": name, "n_slots": n_slots, "n_packets": n_packets,
          "plain_walk_s": plain_s, "rows": rows, "launches": launches,
          "batches": {"fused": n_fused, "split": n_split}})
    return launches


def profile_phase(dev, n_slots: int = 2048, max_batch: int = 512):
    """Where the time goes on the fused path: the device's busy time (sum
    of kernel and copy durations, from torch.profiler) against the
    unprofiled serving wall time, CUDA launches per batch, and the host
    operations that take the most CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.serve.packet_engine import PacketServeEngine

    stages = flow_ddos_stages(n_slots)
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                 seed=STREAM_SEED)
    pipe = StatefulPipeline(stages, backend="cuda", device=dev.type)

    def run():
        eng = PacketServeEngine(pipe, feature_dim=len(traffic.COLUMNS),
                                max_batch=max_batch, depth=2,
                                device=dev.type)
        for _ in eng.serve_stream(stream.chunks(max_batch)):
            pass
        torch.cuda.synchronize()
        return eng.stats()

    plain = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run()
    avg = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in avg
                  if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    batches = profiled["batches"] + 1            # + the warm-up batch
    emit({"phase": "profile", "n_slots": n_slots, "max_batch": max_batch,
          "backend": plain["backend"], "wall_s": plain["wall_s"],
          "dispatch_s": plain["dispatch_s"],
          "pkt_per_s": plain["pkt_per_s"],
          "profiled_wall_s": profiled["wall_s"],
          "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / 1e6 / plain["wall_s"],
          "cuda_launches_per_batch": launches / batches,
          "host_top": [{"op": e.key, "count": e.count,
                        "self_cpu_ms": e.self_cpu_time_total / 1e3}
                       for e in host]})


# ----------------------------------------------------------------- main

KERNELS = (
    ("fused_flow_serve", "src/repro_torch/kernels/fused_flow/csrc/fused_flow.cu",
     "src/repro/kernels/fused_flow/kernel.py:338"),
    ("flow_update", "src/repro_torch/kernels/flow_update/csrc/flow_update.cu",
     "src/repro/kernels/flow_update/kernel.py:235"),
    ("fused_mlp_classify", "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu",
     "src/repro/kernels/fused_mlp/kernel.py:71"),
)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _ext
    except ImportError as e:
        print(f"chip_smoke: the port is missing: {e!r}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    t = time.perf_counter()
    _ext.extension()
    emit({"phase": "build", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    try:
        err, times = kernel_phase(dev)
        main_launches = path_phase(dev, "path_flow_ddos", 2048, (256, 512),
                                   (True, False), N_PACKETS)
        for k in ("fused_flow_serve", "flow_update", "fused_mlp_classify"):
            check(main_launches[k] > 0, f"{k} never launched on the path")
        path_phase(dev, "path_max_slots", 1 << 16, (512,), (True,),
                   N_PACKETS, repeats=3)
        profile_phase(dev)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in KERNELS:
        tm = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": err[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None,
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
