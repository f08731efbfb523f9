#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
``build/torch_kernels/``), then drives the stateful serving paths, the
stateless DAG path, the LM serving paths and the compiler on the card and
checks them, printing one JSON line per phase:

  1. device and build: ``nvidia-smi`` name / power limit, build seconds;
  2. kernels: K1 ``fused_flow_serve``, K2 ``flow_update``, K3
     ``fused_mlp_classify``, K4 ``mat_lut_classify``, K5 ``fused_mlp``
     and K6 ``fused_dag`` against their plain PyTorch versions on the
     card.  ``kernels_check``: the seeded collision patterns of
     ``repro_torch.testing`` at B=512 with 2,048 slots in each of K1's
     readout modes ("all", "hist", "raw"; state exact, verdicts under the
     margin rule), and K1 and K3 at the full-width classifier [28, 128 x
     10, 2].  ``kernels_check_dag``: K5 (logits within 1e-4 * (1 +
     |plain|)) and K6 (plans seq, or, and, a nested DAG with a repeated
     model, a folded FeatureSelect, full width; the fold exact given the
     per-model verdicts, verdicts under the margin rule) at B = 1, 37,
     1,024 and 8,192 rows of the AD test set.  ``kernels_check_suffix``:
     K1's "mat" suffix (argmax and argmin), its "centroid" suffix with
     duplicated centroids, its mitigation phase in "drop" and
     "rate_limit" modes with 2,048 action slots (the flow table's
     segmentation) and 4,096 (its own) on patterns that collide in both
     tables, and K4 on ragged batches; state, action tables and MAT
     verdicts exact, centroid and MLP verdicts under the margin rule.
     ``kernels_time``: each kernel's time per launch over 50
     back-to-back launches (CUDA events) and its device time
     (torch.profiler, the kernel's exact instance, null unless it saw one
     event per call) on a batch of the stream, beside its plain version
     and its bound, K1 in each mode (the full-width MLP included);
     ``kernels_time_dag``: K5 and K6 on 1,024 AD rows at the AD widths,
     K3, K5 and K6 at full width on 128, 1,024 and 4,096.  ``split_action_table``: the split
     path's action table (plain PyTorch on the card) against the
     sequential walk, exact, with CUDA's sync debug mode set to raise;
  3. the paths, each driven with the launch counts set to 0 just before
     and read just after, and held against ``backend="interpret"`` (the
     plain walk, which launches nothing):
     - ``path_flow_ddos``: 2,048 slots, W=28, MLP [28, 16, 8, 2] with
       seeded weights, a 16,000-packet ddos_burst stream (seed 1),
       ``PacketServeEngine(backend="cuda", depth=2)`` at max_batch 256
       and 512, fused (K1) and split (K2 + K3), also against the plain
       whole-stream walk; ``path_max_slots``: 65,536 slots, B=512;
     - ``path_mat_fused`` / ``path_mitigate_fused``
       (benchmarks/flow_throughput.py:58-80): the same prefix with the
       MAT suffix (edges [28, 7], tables [28, 8, 4] from default_rng(7),
       LabelMap [0, 1, 1, 0]), without and with Mitigate(2,048 slots,
       threshold 6): fused (K1) and split (K2 + K4, the action table in
       plain PyTorch on the card, "mixed"); final state, action table
       and verdicts exact; MITIGATED verdicts must occur;
     - ``attack_defense`` (benchmarks/attack_defense.py:47-61,135-170):
       syn_flood, udp_flood and coordinated_ddos at 12,000 packets,
       4,096 action slots, threshold 8, B=512, fused (and syn_flood
       split) against interpret: identical verdicts and tables, zero
       leaked packets in drop mode;
       then a rate_limit run that hot-swaps to an identical pipeline
       mid-stream while flows are limited: the verdict stream unchanged
       and exactly one swap;
     - ``path_dag`` (``benchmarks/dag_throughput.py``, paper Table 3): the
       AD test set (``make_ad_dataset(features=7, n_train=4096,
       n_test=8192)``, chunks of 997, 3 passes) through the stateless
       engine at max_batch 128, 256, 1,024 and 4,096: ``ad > tc`` fused
       (one K6 launch per batch), per model (K3 per model), walked
       (``backend="interpret", fuse=False``: K5 per MLP leaf), ``ad >
       (tc | cl)`` with a centroid leaf ("mixed") and ``ad_full > tc``
       (K6 at full width), each against the plain walk on CPU tensors
       under the margin rule, every dispatch raising nothing under
       ``set_sync_debug_mode("error")`` (a logits program on K5 and a
       swap from it to a DAG included), then a hot swap between two
       DAGs mid-stream.  The models are seeded with He scaling (the
       trainer is not ported);
     pkt/s and p50/p99 batch latency per configuration;
     - ``path_two_table`` (slice 4): the two-table configuration (the
       flow-ddos table and a per-destination-port aggregate, 2,048 slots
       each, W = 28 and 19, one 47-wide classifier;
       ``testing.two_table_stages``), ddos_burst and port_scan at 16,000
       packets, the MLP [47, 16, 8, 2] and the mitigated MAT, B = 256
       and 512, fused (one K1 multi-table launch per batch) and split
       (K2 per table + K3 or K4, the action table graphed), each against
       ``backend="interpret"`` on CPU tensors, the dispatch silent under
       ``set_sync_debug_mode("error")``; then hot swaps flow-ddos ->
       two-table and back (the detection tables start fresh) and once
       more mitigated (the action table carries bit for bit);
     - ``telemetry``: the flow-ddos fused path at B = 512 with telemetry
       off and on, rounds interleaved (off, on, ...): the best
       adjacent-pair on/off pkt/s ratio must reach 0.97, the verdicts
       are bit-identical, the packet counter equals the packets served
       and the mitigated counter the MITIGATED verdicts of
       path_mitigate_fused;
  4. where the time goes on the fused stateful paths (the two-table one
     included) and the fused DAG: device busy time (profiler) against
     the serving wall time, launches per batch, top host ops.

Slice 4 also adds ``kernels_check_multi`` (K1's multi-table mode against
its plain version: every suffix with and without the action table, B =
1, 37 and 512, ragged, collision patterns, the full-width classifier and
five tables; tables exact, MAT and mitigated verdicts exact, MLP and
centroid verdicts under the margin rule) and ``kernels_time_multi`` (its
time per suffix beside its plain version and bound).

Slice 5 adds LM serving on the dense family: ``kernels_check_lm`` (K7
``flash_attention`` against its plain version at the Qwen3-1.7B prefill
shapes B = 4, S = 512 and 2,048, H = 16 over K = 8, D = 128, bf16,
causal; decode Sq = 1 against 1,024 keys at q_offset 0, 511 and 1,023;
ragged S = 1,000 with windows 256 and 4,096; G = 12; D = 16, 32 and 64;
f32; the Jamba-1.5-Large shapes H = 64 over K = 8 at S = 512 and 192
and decode at q_offset 255 and 543; since slice 8 also the split-KV
decode's chunk edges at G = 8, a windowed decode, Sq = 4 and 5 either
side of the decode threshold and bf16 at D = 32 and 64, every case
against the plain version and against the plain decomposition of the
kernel it takes; within 1e-5 in f32 and 8e-3 of the output's scale in
bf16), ``kernels_time_lm`` (K7's wrapper and device time, summed over a
call's kernels, at the Qwen3 and Jamba shapes and for the f32 instance,
beside its plain version, ``scaled_dot_product_attention`` on the same
inputs as ``library_ms`` with its own device time, and its bound) and
``path_lm_serve``
(``ServeEngine`` with Qwen3-1.7B at full width and depth, seeded bf16
weights, 4 slots, 8 requests of 32 new tokens, K7 launched 28 x (prefill
+ decode calls) times; against ``backend="interpret"`` and against
teacher forcing).

Slice 6 adds hybrid LM serving: ``kernels_check_scan`` (K8
``selective_scan`` against its plain version at the Jamba path's shapes
B = 4, di = 16,384, N = 16 at S = 512, 256, 192 and 1 with a random h0,
with uniform and with realistic dA = exp(dt * A); N = 8 at di = 128; S =
3; y and h_final within 1e-5 * (1 + |plain|)), ``kernels_time_scan`` (K8
at prefill S = 512 and decode S = 1 beside its plain version and its
bound; no PyTorch call computes the scan) and ``path_hybrid_serve``
(``ServeEngine`` with Jamba-1.5-Large at full width, one 8-layer period,
experts 0-7 of 16, seeded bf16 weights: four 512-token prompts with 32
new tokens, then four of 160-192 tokens with 64; K8 launched 7 x (2 +
96) = 686 times (since slice 11 its discretizing entry) and K7 98; in bf16 the period's Mamba, attention and MoE
blocks against their plain versions on the path's own input; in f32,
experts 0-1, against ``backend="interpret"`` and round 2 against teacher
forcing on a drop-free rerun).

Slice 7 adds the compiler and the last kernel: ``kernels_check_bgemm``
(K9 ``binarized_gemm`` against its plain version int for int: ragged B =
37, K = 200, N = 45 with 0, -0.0 and NaN planted, in f32 and bf16; bf16
at 256 x 1,000 x 96; 1,024 x 128 x 128; 4,096^3), ``kernels_time_bgemm``
(K9 at 1,024 x 128 x 128 and 4,096^3 beside its plain version, its bound
and ``torch._int_mm`` on pre-signed int8 operands, which leaves out the
sign pass) and ``path_generate`` (the quickstart program,
``examples/quickstart.py``, through ``repro_torch.facade.generate`` at
its own size, budget 14: every DNN candidate trained on the card, the
pipeline on K3, ``verify`` under the margin rule, served through the
stateless engine at B = 1,024; then the same data on Tofino at budget 8,
a MAT on K4, exact against the plain walk).  No path runs K9: the JAX
package has no stage that lowers onto it.

Slice 9 redesigns K1 and K2 (the slot-chain walk with its operands
staged off the chain; K1 one cooperative launch for one table or many,
classifying after the walk, one warp per packet).  ``kernels_check``,
``kernels_check_suffix`` and ``kernels_check_multi`` gain the chunk-edge
patterns of ``repro_torch.testing`` (chains of 1, 31, 32, 33, 64 and
254 / 512 packets, evictions at a chunk's first packet, -0.0
increments), also with bins as RegisterUpdate makes them (no column
hit twice, so every chunk takes the fast walk), a table with no
histograms, and a check of every K1/K2 table, and of the mitigated
verdicts, against the decomposition the kernels walk by
(``flow_update_staged_ref``, ``mitigate_update_staged``);
``kernels_time_chain`` times K1 ("mlp") and K2 at B = 512 with deepest
chains of 1, 135 and 512 packets and reports the slope, device ns per
chain step, beside a model (not a measurement) of the chain's latency
floor.

Slice 11 redesigns K7's f32 instance and K8.  K7 in f32 takes the
split-KV decode (``fa_decode_kernel<float, D>``, one template with the
bf16 one) at Sq <= 4 and a register-tiled f32 prefill
(``fa_prefill_f32_kernel<D>``) above; ``kernels_check_lm`` and
``kernels_time_lm`` gain f32 at the Jamba shapes and decode at q_offset
1,023 (and f32 decode edges), each beside SDPA.  K8 gains a discretizing
entry (``selective_scan_discretized``: dt, A, B, C and x in, dA and dBx
formed in registers), which the Mamba block runs; the TPU kernel's
interface stays as another instance of one template.
``kernels_check_scan`` runs every case through both: the discretizing
entry's h_final bit for bit the eager discretization followed by the
TPU-interface K8, and each entry's y bit for bit the kernel's own order
written out (``selective_scan_channel_ref``) and within 1e-5 of the
plain version; ``kernels_time_scan`` times the discretizing entry beside
the eager passes plus the TPU-interface K8, its "before".
``path_hybrid_serve`` counts the discretizing entry's launches.

Slice 10 redesigns K3, K5 and K6 for Hopper (``csrc/mlp_tile.cuh``: a
model past one weight chunk goes through a tile of rows per block, its
weights streamed through shared memory by bulk copies; smaller models
keep one warp a row).  ``kernels_check_dag`` adds K3 beside K5 at the
design space's full-width DNN with 7, 30 and 47 inputs, a 256-wide
model, 16 layers and a 1-wide input, at B = 1, 31, 37, 128, 1,024, 4,096
and 8,192, and K6 on ``ad_full > tc`` and on two full-width models under
"or" at the same sizes, each against the plain version and against
``mlp_tile_ref`` (the tiled schedule written out); ``kernels_time_dag``
times the full-width K3, K5 and K6 at B = 128, 1,024 and 4,096, which the
kernels line carries under ``full_width``.

Slice 12 redesigns K4 and K9.  K4 (``mat_lut_kernel<split, cpl>``)
stages the edges and tables by bulk copies on two mbarriers, takes 8
rows a warp (4 when it splits a feature's edge count across the warp,
above 32 edges) and issues a chunk's table loads before its adds;
``kernels_check_mat`` holds it against ``mat_classify_ref`` and
``mat_classify_split_ref`` (its schedule written out) at the Tofino
shape of ``path_generate`` (7 features, 512 bins, 2 classes: 511 edges)
with edge values, NaN, +-inf, -0.0 and 0.0 planted and one unsorted edge
row, and at the mat-fused shape, and ``kernels_time`` times it at both
shapes beside the launch floor (a one-element ``torch.zeros`` fill).
K9 is two launches: the int8 signs of both operands
(``bgemm_sign_pack``, w's transposed) and their product on the int8
tensor cores (``bgemm_wgmma_kernel``: wgmma with TMA loads);
``kernels_time_bgemm`` times ``torch._int_mm`` with its second operand
row-major and column-major, each checked equal to K9's result.

Slice 13 adds the online loop, fusion and Table 3's accounting, after
the other paths.  ``path_online`` (``examples/hot_swap.py`` on the card:
concept_drift streams of 24,000 packets, 2,048 slots, chunks of 512,
depth 2) trains the initial model from a K2 replay of phase A
(``traffic.stream_feature_dataset``, bit for bit its plain version on
the CPU) and ``dse.retrain_model`` on the card, serves it fused (K1),
and lets a ``DriftDetector`` / ``HotSwapController`` retrain on a worker
thread (its own CUDA stream, the trainer's graph captured thread-local)
while serving goes on; a probe engine serves while the retrain still
runs.  It holds the example's gates (one episode, no errors, the swap
installed at the next flush, keys and registers bit-identical across
it, one verdict per packet, F1 > 0.85 / < 0.5 / > 0.85) and reports the
retrain's wall seconds, the swap latency and the serving pkt/s and p99
before the drift, during the retrain and after the swap.
``path_fusion`` (``benchmarks/table4_fusion.py``: the AD data at 7
features, 8,192 / 4,096 rows, in halves) trains two separate DNNs and
one fused model on the card, holds Table 4's CU gate (fused < 0.7 x
separate), both F1 > 0.6 and within 0.1, serves each task's pipeline on
K3 (verdicts equal to ``FusedModel.predict`` under the margin rule), and
runs ``strategy_table`` over path_dag's ``ad > tc`` strategies (a
repeated model counted once).  ``telemetry`` also reports each
recording site's host cost per batch (``hook_costs``) and the host
dispatch time per batch with telemetry off and on, in turns.

Slice 14 adds sharded packet serving and the MoE family.
``path_sharded`` (after ``path_two_table``) serves flow-ddos (K1, or K2 +
K3) and mitigate-fused (K1, or K2 + K4 and the graphed action table),
16,000 ddos_burst packets, B = 512, depth 2, through
``ShardedPacketServeEngine`` with the card listed 1, 2 and 4 times (each
entry a shard with its own table): each shard's tables and verdicts bit
for bit those of a single-device ``backend="cuda"`` engine fed that
shard's rows in arrival order; its tables bit for bit the plain walk's,
MAT and mitigated verdicts exact against ``interpret``, MLP verdicts
under the margin rule; ``serve_route_overflow_total`` equal to the
push-backs ``route_prefix`` gives replayed on the host; ``shards == n``;
the routed dispatch silent under ``set_sync_debug_mode("error")``; a
mid-stream swap at n = 4 to twice the slots, each shard's table then
``migrate_state`` of its own; ``ad > tc`` on K6 over 4 shards row for row
the single-device engine's.  pkt/s and p50 / p99 per n are reported, not
gated.  ``path_moe_serve`` (after ``path_hybrid_serve``, whose weights
it frees first) serves Moonshot-v1-16B-A3B through ``ServeEngine``: in
bf16 at full width and depth (48 layers, 56.1 GB), K7 48 x (prefill +
decode calls) launches, with per-block gates (layer 0's attention on K7,
its MoE FFN against a plain per-expert gather); in f32 at 8 layers,
prefill logits within 0.1 of ``interpret``, tokens under the 0.2
margin, teacher forcing on a drop-free rerun.

Slice 15 adds the remaining LM families after ``path_moe_serve``, each
at full width on ``backend="cuda"`` against ``"interpret"``, K7
launching once per attention and cross-attention layer a call and
nothing else (``k7_per_run``), each phase's seconds printed.
``path_mixtral_serve``: Mixtral-8x7B, 32 layers with experts 0-3 in
bf16 (48.3 GB), 2 slots of max_seq 4,352 (a rolling cache of 4,096),
two 4,096-token prompts whose 128 new tokens wrap the ring, then two
short ones; per-block gates (layer 0's windowed prefill where S >
window and its ring decode steps on K7, its MoE FFN against a per-expert
gather), and in f32 at 4 layers with all 8 experts every layer's blocks,
the routing near-tie rule and the dense family's token and
teacher-forcing gates on a drop-free rerun.  ``path_vlm_serve``:
Llama-3.2-Vision-11B, 40 layers (8 gated cross-attentions over 6,404
image tokens), and ``path_encdec_serve``: SeamlessM4T-large-v2, 12 + 12
layers; each serves the engine's zero stubs for tok/s, then a run with
the gates drawn non-zero and seeded memories (``gated_serve``) whose
cross-attention, self-attention (and encoder) blocks are gated on K7
against the plain attention in bf16 and f32, with the dense family's
end-to-end gates in f32.  ``path_xlstm_serve``: xLSTM-1.3B, 24 of its
48 blocks (``XL_LAYERS``, since slice 20), no kernel launches, decode through the recurrent state against teacher
forcing in bf16 and f32.  ``kernels_check_lm`` adds those call forms of
K7 (``K7_CASES``: a windowed prefill past the window, ring decodes,
non-causal cross and encoder calls, bf16 and f32) and
``kernels_time_lm`` times them (``K7_TIMED_FORMS``).  A ``{"phase":
"total"}`` line gives the smoke's seconds.

Slice 18 adds hybrid training: ``kernels_check_scan_bwd`` (K8b, the
gradient of K8's discretizing entry, after K8's checkpointing launch,
against ``selective_scan_bwd_ref`` and ``selective_scan_bwd_chunked_ref``
at ``K8B_CASES``: the training shape, x in f32 with random h0 and
dh_final, ragged S and di at N = 8, S = 1, S = 83, the smoke width;
bit-identical across calls, the checkpoints bit for bit the plain
forward's), ``kernels_time_scan_bwd`` (its two kernels per case, the
plain version at the training shape, K8's checkpointing forward beside
its serving instance) and ``path_hybrid_train`` (after
``path_lm_restart``: one Jamba-1.5-Large period at full width, experts
0-1, Adafactor with bf16 master weights, 8 steps of 4 x 1,024 tokens on
K8, K8b, K7 and K7b; K8b on layers 0's and 6's own inputs, K7b on layer
4's, the smoke config's f32 gradients against ``interpret``); the
large-score K7b case is gated, and ``grad_refusals`` holds K8's TPU
interface and K9 only.

Slice 20 adds ``path_launch`` (after ``path_lm_restart``): Qwen3-1.7B at
full width trained 3 steps through ``repro_torch.launch.train.main`` and
held to the same steps run by hand, then served through
``repro_torch.launch.serve.main`` and held to a ``ServeEngine`` fed the
same params and requests; K7 and K7b counted on both.

Then it prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
exits 1; a missing GPU, torch or ``src/repro_torch`` exits 2 and prints
why on both output streams; neither prints the ``ok`` line.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
# (non-tensor-core) FLOP/s — the denominators of each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

B_KERNEL, S_KERNEL = 512, 2048
FULL_HIDDEN = (128,) * 10          # the design space's deepest DNN
N_PACKETS, STREAM_SEED, MLP_WIDTHS = 16_000, 1, (28, 16, 8, 2)
TIMED_LAUNCHES = 50
# mat-fused / mitigate-fused (benchmarks/flow_throughput.py:58-80)
MIT_SLOTS, MIT_THRESHOLD = 2048, 6
# attack/defense (benchmarks/attack_defense.py:47-61)
AD_PACKETS, AD_MIT_SLOTS, AD_THRESHOLD, AD_BATCH = 12_000, 4096, 8, 512
AD_SCENARIOS = ("syn_flood", "udp_flood", "coordinated_ddos")
AD_TRAIN_SEED, AD_KEEP_EVERY = 0, 4


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


def mat_fused_stages(n_slots: int, mitigated: bool):
    """The mat-fused pipeline, with Mitigate for mitigate-fused."""
    from repro_torch.core import stageir
    from repro_torch.data import traffic
    from repro_torch.flowstate import MitigationSpec
    from repro_torch.testing import mat_stages

    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=n_slots)
    stages = [fk, ru, ws] + mat_stages(ws.n_out)
    if mitigated:
        stages.append(stageir.Mitigate(MitigationSpec(
            n_slots=MIT_SLOTS, threshold=MIT_THRESHOLD)))
    return stages


def attack_defense_stages(scenario: str, mode: str = "drop"):
    """The attack/defense pipeline: the flow-ddos prefix, the seeded MLP
    [28, 16, 8, 2] with the input standardisation of the scenario's
    training stream (seed 0) folded in, and Mitigate(4,096 slots,
    threshold 8).  The reference trains the MLP (``train_dnn``, not
    ported); the weights here are random."""
    from repro_torch.core import stageir
    from repro_torch.data import traffic
    from repro_torch.flowstate import MitigationSpec
    from repro_torch.testing import random_mlp, readout_moments

    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=S_KERNEL)
    train = traffic.make_stream(scenario, n_packets=AD_PACKETS,
                                seed=AD_TRAIN_SEED)
    mu, sd = readout_moments([fk, ru, ws], train.packets)
    w, b = random_mlp(MLP_WIDTHS, seed=0)
    detector = traffic.fold_input_standardization(
        [stageir.FusedMLP(w, b), stageir.Reduce("argmax")], mu, sd)
    return [fk, ru, ws] + detector + [stageir.Mitigate(MitigationSpec(
        n_slots=AD_MIT_SLOTS, mode=mode, threshold=AD_THRESHOLD,
        keep_every=AD_KEEP_EVERY))]


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
    """Device time per call of each CUDA kernel, from one torch.profiler
    run: ``calls`` maps a kernel's exact name — a template by its
    instance, as the profiler demangles it (``fused_flow_kernel<1,
    true>``) — to a function that launches it once.  -> {name: {"ms",
    "events", "keys"}}: "events" counts the profiler's kernel events of
    exactly that name, "ms" is their mean device time (None without an
    event), and "keys" lists, when there were not n events, every kernel
    key that holds the name's stem, to show what the profiler saw.  (The
    profiler has recorded 19 of 20 multi-table launches in one process,
    20 of 20 in another: the mean of the events it saw is the kernel's
    time either way.)"""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    avg = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    out = {}
    for kernel in calls:
        exact = re.compile(r"(^|[\s:])" + re.escape(kernel) + r"\(")
        hits = [e for e in avg if exact.search(e.key)]
        events = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits)
        stem = kernel.split("<")[0]
        out[kernel] = {
            "ms": us / events / 1e3 if events else None, "events": events,
            "keys": [] if events == n else
            [f"{e.key[:120]} x{e.count}" for e in avg if stem in e.key]}
    return out


def call_device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn()``, every CUDA kernel it launches
    summed (one torch.profiler run of n calls): a library call's own
    device time, whatever its kernels are named."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


# K1's template instance, as the profiler names it: the suffix kind's
# index in SUFFIX_KINDS and the table descriptors it carries (1 for one
# table, MAX_TABLES for several)
K1_INSTANCE = "fused_flow_kernel<{kind}, {cap}>"
# K3 and K5 are one template, by whether it writes logits; a model past
# one weight chunk runs the tile kernels (``fused_mlp.tiled``)
K3_INSTANCE, K5_INSTANCE = "fused_mlp_kernel<false>", "fused_mlp_kernel<true>"
K3_TILE, K5_TILE = "fused_mlp_tile_kernel<false>", "fused_mlp_tile_kernel<true>"
K6_NAME, K6_TILE = "fused_dag_kernel", "fused_dag_tile_kernel"


def mlp_kernel_names(n_weights: int) -> tuple[str, str, str]:
    """The profiler names of K3, K5 and K6 for models of ``n_weights``."""
    from repro_torch.kernels import fused_mlp as fm

    return ((K3_TILE, K5_TILE, K6_TILE) if fm.tiled(n_weights)
            else (K3_INSTANCE, K5_INSTANCE, K6_NAME))


def kernel_fields(seen: dict) -> dict:
    """``kernel_device_ms``'s reading of one kernel -> the timing
    entry's "kernel_ms" and, for a count that is not the call count,
    what the profiler saw."""
    out = {"kernel_ms": seen["ms"], "kernel_events": seen["events"]}
    if seen["keys"]:
        out["kernel_keys"] = seen["keys"]
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
    path runs), and a table with no histograms.  The chunk-edge patterns
    (``testing.EDGE_PATTERNS``: chains of 1, 31, 32, 33, 64 and 254 or
    512 packets, evictions at a chunk's first packet, -0.0 increments)
    run on the flow-ddos, the 246-word and the histogram-less tables, and
    again on the flow-ddos and 246-word tables with bins as RegisterUpdate
    makes them (no column hit twice, so no chunk leaves the fast walk)."""
    from repro_torch.flowstate.registers import FlowStateSpec
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import EDGE_PATTERNS, PATTERNS, he_mlp, random_mlp

    stages = flow_ddos_stages(S_KERNEL)
    spec = stages[1].spec
    mlp = fm.pack_params(stages[3].weights, stages[3].biases, device=dev)
    wide = FlowStateSpec(n_slots=S_KERNEL, n_counters=3, n_ewma=3,
                         hist_sizes=(100, 90, 50), ewma_alpha=0.5)
    bare = FlowStateSpec(n_slots=S_KERNEL, n_counters=2, n_ewma=1,
                         hist_sizes=(), ewma_alpha=0.25)

    def seeded_mlp(sp_, mode, hidden, classes, seed):
        widths = (table_plan(sp_, mode).n_out, *hidden, classes)
        return fm.pack_params(*random_mlp(widths, seed=seed), device=dev)

    wide_mlp = seeded_mlp(wide, "all", (64,), 4, 3)
    hist_mlp = seeded_mlp(spec, "hist", (16, 8), 2, 4)
    raw_mlp = seeded_mlp(spec, "raw", (16, 8), 2, 5)
    wide_hist_mlp = seeded_mlp(wide, "hist", (64,), 4, 6)
    bare_mlp = seeded_mlp(bare, "all", (16,), 2, 7)
    # the design space's deepest DNN at the flow-ddos readout: 611 KB of
    # parameters, read from device memory instead of shared memory
    full_mlp = fm.pack_params(*he_mlp((spec.width,) + FULL_HIDDEN + (2,),
                                      seed=0), device=dev)
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
             + [(wide, "hist", wide_hist_mlp, "mixed", True)]
             + [(spec, "all", full_mlp, p, r) for p, r in (
                 ("mixed", True), ("same_slot", False))]
             + [(sp_, "all", m_, p, False) for sp_, m_ in (
                 (spec, mlp), (wide, wide_mlp), (bare, bare_mlp))
                for p in EDGE_PATTERNS]
             + [(bare, "all", bare_mlp, "mixed", True)])
    cases = ([c + (True,) for c in cases]
             + [(sp_, "all", m_, p, False, False) for sp_, m_ in (
                 (spec, mlp), (wide, wide_mlp)) for p in EDGE_PATTERNS])
    for i, (sp_, mode, mlp_, pattern, ragged, dup) in enumerate(cases):
        for k, e in check_kernels(dev, sp_, mode, mlp_, pattern, ragged,
                                  seed=100 + i, dup_bins=dup).items():
            err[k] = max(err[k], e)
    emit({"phase": "kernels_check", "cases": len(cases), "B": B_KERNEL,
          "n_slots": S_KERNEL,
          "widths": [spec.width, wide.width, bare.width],
          "modes": sorted({c[1] for c in cases}),
          "edge_patterns": list(EDGE_PATTERNS),
          "distinct_bins_cases": [f"{c[3]} W={c[0].width}" for c in cases
                                  if not c[5]],
          "max_abs_err": err})
    err.update(suffix_kernel_phase(dev))
    err["mat_lut_classify"] = max(err["mat_lut_classify"],
                                  kernels_check_mat(dev))
    kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
              alpha=spec.ewma_alpha)
    return err, timing(dev, stages, table_plan(spec, "all"),
                       ff.SuffixPlan("mlp", mlp.num_classes), mlp, kw)


def check_kernels(dev, spec, mode: str, mlp, pattern: str, ragged: bool,
                  seed: int, dup_bins: bool = True):
    """One batch through K2, K1 (readout ``mode``) and K3 and their plain
    versions, against a table a previous batch of the same pattern left
    (bins as ``testing.flow_batch`` plants them with ``dup_bins``);
    K2 and K1's tables also against the decomposition the kernels walk by
    (``flow_update_staged_ref``) -> max abs error per kernel (raises on
    any disagreement)."""
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
            spec, pattern, B_KERNEL, seed=s, ragged=r,
            dup_bins=dup_bins).items()}

    t, t0 = batch(seed, ragged), batch(seed + 1000, False)
    empty = (torch.full((spec.n_slots,), -1, dtype=torch.int32, device=dev),
             torch.zeros((spec.n_slots, spec.width), device=dev))
    # a table the batch partly continues and partly evicts
    keys, regs, _ = fu.flow_update_ref(*empty, t0["pkt_keys"], t0["upd"],
                                       t0["bins"], t0["valid"], **kw)
    ops = (keys, regs, t["pkt_keys"], t["upd"], t["bins"], t["valid"])
    rk, rr, rf = fu.flow_update_ref(*ops, **kw)
    sk, sr, sf = fu.flow_update_staged_ref(*ops, **kw)
    z = ff.suffix_readout(rf, tp)
    logits = ff.ref.suffix_logits(z, mlp)
    name = f"{pattern} W={spec.width} mode={mode} dup_bins={dup_bins}"

    def bits(x):
        return x.view(torch.int32)

    # the ops update the table they are given in place: give them copies
    k2, r2, f2 = fu.flow_update(keys.clone(), regs.clone(), *ops[2:], **kw)
    torch.cuda.synchronize()
    check(torch.equal(k2, rk) and torch.equal(bits(r2), bits(rr))
          and torch.equal(bits(f2), bits(rf)), f"K2 differs on {name}")
    check(torch.equal(k2, sk) and torch.equal(bits(r2), bits(sr))
          and torch.equal(bits(f2), bits(sf)),
          f"K2 differs from the decomposition on {name}")
    k1, r1, v1 = ff.fused_flow_serve(keys.clone(), regs.clone(), *ops[2:],
                                     tp, sp, mlp)
    torch.cuda.synchronize()
    check(torch.equal(k1, rk) and torch.equal(bits(r1), bits(rr))
          and torch.equal(k1, sk) and torch.equal(bits(r1), bits(sr)),
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


def suffix_kernel_phase(dev):
    """K1's "mat" and "centroid" suffixes and its mitigation phase, and
    K4, against their plain versions on the card.  Each K1 case applies
    two batches of a pattern (the second ragged) to the flow-ddos table,
    the first leaving a table the second partly continues and partly
    evicts; keys, rows, action keys and rows must be bit-exact, MAT and
    mitigated verdicts exact, centroid verdicts under the margin rule.
    The chunk-edge patterns run with and without the action table, also
    with bins as RegisterUpdate makes them (no column hit twice, so no
    chunk leaves the fast walk), and every case is also held against the
    decomposition K1 walks by:
    the staged flow walk, the plain classifier and the chunked action
    walk (``mitigate_update_staged``).  -> max abs error per kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import flow_update as fu
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mat_lut as ml
    from repro_torch.testing import (
        EDGE_PATTERNS,
        flow_batch,
        mat_stages,
        random_mlp,
        verdict_mismatches,
    )

    spec = flow_ddos_stages(S_KERNEL)[1].spec
    W = spec.width
    tp = table_plan(spec, "all")
    mat_st = mat_stages(W)
    mats = {m: ml.pack_mat(mat_st[0].edges, mat_st[1].tables,
                           mat_st[3].table, use_min=m, device=dev)
            for m in (False, True)}
    rng = np.random.default_rng(11)
    cent = (rng.random((4, 6)) * np.asarray([40, 1, 1, 1, 1, 1])
            ).astype(np.float32)
    cent[2] = cent[0]                        # duplicated: exact ties
    fidx = (0, 2, 4, 5, 9, 12)
    cents = ff.pack_centroids(cent, [0, 1, 0, 1], fidx, use_min=True,
                              device=dev)
    mlp = fm.pack_params(*random_mlp((W, 16, 8, 2), seed=0), device=dev)
    suffixes = {
        "mat": (ff.SuffixPlan("mat", 4), mats[False]),
        "mat_min": (ff.SuffixPlan("mat", 4), mats[True]),
        "centroid": (ff.SuffixPlan("centroid", 4), cents),
        "mlp": (ff.SuffixPlan("mlp", 2), mlp),
    }
    cases = ([(k, None, None, p) for k in ("mat", "mat_min", "centroid")
              for p in ("slot_runs", "one_hot_flow", "same_slot")]
             + [(k, sm, mode, p) for k in ("mat", "centroid")
                for sm in (S_KERNEL, 2 * S_KERNEL)
                for mode in ("drop", "rate_limit")
                for p in ("slot_runs", "one_hot_flow")]
             + [("mlp", 2 * S_KERNEL, mode, "slot_runs")
                for mode in ("drop", "rate_limit")]
             + [(k, None, None, p) for k in ("mat", "centroid")
                for p in EDGE_PATTERNS]
             + [("mat", S_KERNEL, "drop", "chain_edges"),
                ("mat", 2 * S_KERNEL, "rate_limit", "one_chain"),
                ("centroid", 2 * S_KERNEL, "drop", "one_chain"),
                ("mlp", S_KERNEL, "rate_limit", "chain_edges")])
    cases = ([c + (True,) for c in cases]
             + [(k, sm, mode, p, False) for k, sm, mode in (
                 ("mat", None, None), ("mlp", S_KERNEL, "drop"),
                 ("centroid", 2 * S_KERNEL, "rate_limit"))
                for p in EDGE_PATTERNS])
    err = {"fused_flow_serve": 0.0, "mat_lut_classify": 0.0}
    dropped = 0
    for i, (kind, sm, mode, pattern, dup) in enumerate(cases):
        sp, params = suffixes[kind]
        mit = None
        if sm is not None:
            mit = (torch.full((sm,), -1, dtype=torch.int32, device=dev),
                   torch.zeros((sm, 2), device=dev),
                   ff.MitigationSpec(n_slots=sm, mode=mode, threshold=3,
                                     keep_every=3))
        keys = torch.full((spec.n_slots,), -1, dtype=torch.int32,
                          device=dev)
        regs = torch.zeros((spec.n_slots, W), device=dev)
        name = f"{kind} {pattern} mit={sm} {mode} dup_bins={dup}"
        for step in range(2):
            b = {k: torch.as_tensor(v, device=dev) for k, v in flow_batch(
                spec, pattern, B_KERNEL, seed=200 + 2 * i + step,
                ragged=step == 1, key_slots=max(spec.n_slots, sm or 0),
                dup_bins=dup).items()}
            ops = (keys, regs, b["pkt_keys"], b["upd"], b["bins"],
                   b["valid"])
            ref = ff.fused_flow_serve_ref(*ops, tp, sp, params, mit)
            got = ff.fused_flow_serve(
                keys.clone(), regs.clone(), *ops[2:], tp, sp, params,
                None if mit is None else (mit[0].clone(), mit[1].clone(),
                                          mit[2]))
            torch.cuda.synchronize()
            for r, g in zip(ref[:-1], got[:-1]):
                bits = (lambda x: x.view(torch.int32)) \
                    if r.dtype == torch.float32 else (lambda x: x)
                check(torch.equal(bits(r), bits(g)),
                      f"K1 state differs on {name}")
                err["fused_flow_serve"] = max(err["fused_flow_serve"],
                                              max_abs(r, g))
            # the decomposition: staged walk, classifier, chunked walk
            kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
                      alpha=spec.ewma_alpha)
            dk, dr, feats = fu.flow_update_staged_ref(*ops, **kw)
            dec = [dk, dr]
            if mit is not None:
                dec += ff.mitigate_update_staged(
                    mit[0], mit[1], ops[2], ff.suffix_verdicts(
                        ff.suffix_readout(feats, tp), params, sp),
                    ops[5], spec=mit[2])
            for d, g in zip(dec, got):
                bits = (lambda x: x.view(torch.int32)) \
                    if d.dtype == torch.float32 else (lambda x: x)
                check(torch.equal(bits(d), bits(g)),
                      f"K1 differs from the decomposition on {name}")
            if kind == "centroid" or kind == "mlp":
                # verdicts under the margin rule: the plain scores
                z = ff.suffix_readout(feats, tp)
                sc = ff.suffix_scores(z, params, sp).cpu().numpy()
                lm = (params.lmap.cpu().numpy() if kind == "centroid"
                      else None)
                ok = got[-1].cpu().numpy()
                if mit is not None:          # margin rows would show here
                    check(np.array_equal(ok, ref[-1].cpu().numpy()),
                          f"K1 mitigated verdicts differ on {name}")
                else:
                    bad, _ = verdict_mismatches(
                        ok, sc, use_min=kind == "centroid", label_map=lm)
                    check(bad == 0, f"K1 verdicts differ on {name}")
            else:
                check(torch.equal(ref[-1], got[-1]),
                      f"K1 verdicts differ on {name}")
            if mit is not None:
                dropped += int((got[-1] == -1).sum())
                mit = (ref[2], ref[3], mit[2])
            keys, regs = ref[0], ref[1]
    check(dropped > 0, "no mitigation case dropped a packet")
    # K4 on ragged batches, rows that hit edge values exactly
    edges = mat_st[0].edges
    for B in (1, 37, 517, 4096):
        x = (rng.random((B, W)) * 2).astype(np.float32)
        x[:, 0] = rng.integers(0, 10, B)
        hit = rng.random((B, W)) < 0.2
        x[hit] = edges[np.nonzero(hit)[1], rng.integers(0, 7, hit.sum())]
        xt = torch.as_tensor(x, device=dev)
        for mat in mats.values():
            got = ml.mat_classify(xt, mat)
            want = ml.mat_classify_ref(xt, mat.edges, mat.tables, mat.lmap,
                                       use_min=mat.use_min)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K4 differs at B={B}")
            err["mat_lut_classify"] = max(err["mat_lut_classify"],
                                          max_abs(got, want))
    emit({"phase": "kernels_check_suffix", "cases": len(cases),
          "edge_patterns": list(EDGE_PATTERNS),
          "distinct_bins_cases": [f"{c[0]} mit={c[1]} {c[3]}" for c in cases
                                  if not c[4]],
          "k4_batches": [1, 37, 517, 4096], "B": B_KERNEL,
          "n_slots": S_KERNEL, "mit_slots": [S_KERNEL, 2 * S_KERNEL],
          "dropped": dropped, "max_abs_err": err})
    return err


# K4's template instance, as the profiler names it: whether the edge
# count is split across the warp (E > 32) and the classes per lane
K4_INSTANCE = "mat_lut_kernel<{split}, {cpl}>"
# path_generate's Tofino MAT: the quickstart's 7 features, stageir.MAT_BINS
# = 512 bins (511 edges) and 2 classes
K4_TOFINO = (7, 512, 2)
K4_TOFINO_BATCHES = (1, 37, 1024, 2048)
K4_TOFINO_TIMED = (1024, 2048)


def k4_instance(mat) -> str:
    E, C = mat.edges.shape[1], mat.num_classes
    return K4_INSTANCE.format(split=str(E > 32).lower(),
                              cpl=1 if C <= 32 else 4)


def tofino_mat(dev, seed: int, unsorted: bool = True):
    """A MAT of the Tofino shape: per feature the codegen's evenly spaced
    edges over a symmetric range, with 0.0 exactly at the middle edge,
    feature 3's edges shuffled (``unsorted``), seeded normal tables."""
    import numpy as np

    from repro_torch.kernels import mat_lut as ml

    F, bins, C = K4_TOFINO
    rng = np.random.default_rng(seed)
    hi = rng.random(F) * 4 + 1
    edges = np.stack([np.linspace(-h, h, bins + 1)[1:-1] for h in hi]
                     ).astype(np.float32)
    edges[:, (bins - 2) // 2] = 0.0
    if unsorted:
        rng.shuffle(edges[3])
    tables = rng.normal(size=(F, bins, C)).astype(np.float32)
    return ml.pack_mat(edges, tables, device=dev)


def planted_rows(rng, B: int, edges):
    """Normal rows with 20 % of the values set to edge values exactly and
    3 % each to NaN, +inf, -inf, -0.0 and 0.0."""
    import numpy as np

    F, E = edges.shape
    x = (rng.normal(size=(B, F)) * 2).astype(np.float32)
    u = rng.random((B, F))
    hit = u < 0.2
    x[hit] = edges[np.nonzero(hit)[1], rng.integers(0, E, int(hit.sum()))]
    for i, v in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0)):
        x[(u >= 0.2 + 0.03 * i) & (u < 0.23 + 0.03 * i)] = v
    return x


def kernels_check_mat(dev) -> float:
    """K4 against ``mat_classify_ref`` and ``mat_classify_split_ref`` (its
    schedule written out), exactly: the Tofino shape (split count) at B =
    1, 37, 1,024 and 2,048 with planted rows, sorted and with one
    unsorted edge row, argmax and argmin; the mat-fused shape (one lane a
    feature) with planted rows; a MAT of 100 classes (four a lane).
    -> max abs error."""
    import numpy as np
    import torch

    from repro_torch.kernels import mat_lut as ml
    from repro_torch.testing import mat_stages

    rng = np.random.default_rng(24)
    mst = mat_stages(28)
    wide_e = np.sort(rng.normal(size=(9, 40)), 1).astype(np.float32)
    mats = {"tofino": tofino_mat(dev, 1, unsorted=False),
            "tofino_unsorted": tofino_mat(dev, 2),
            "mat_fused": ml.pack_mat(mst[0].edges, mst[1].tables,
                                     mst[3].table, device=dev),
            "classes_100": ml.pack_mat(
                wide_e, rng.normal(size=(9, 41, 100)).astype(np.float32),
                device=dev)}
    rows, worst = [], 0.0
    for name, mat in mats.items():
        for use_min in (False, True):
            m = mat._replace(use_min=use_min)
            for B in K4_TOFINO_BATCHES:
                x = torch.as_tensor(planted_rows(
                    rng, B, mat.edges.cpu().numpy()), device=dev)
                got = ml.mat_classify_launch(x, m)
                want = ml.mat_classify_ref(x, m.edges, m.tables, m.lmap,
                                           use_min=use_min)
                split = ml.mat_classify_split_ref(x, m.edges, m.tables,
                                                  m.lmap, use_min=use_min)
                torch.cuda.synchronize()
                check(torch.equal(split, want), f"K4's schedule written out "
                      f"differs from the plain version on {name} B={B}")
                check(torch.equal(got, want),
                      f"K4 differs on {name} use_min={use_min} B={B}")
                worst = max(worst, max_abs(got, want))
        rows.append({"mat": name, "shape": [*mat.edges.shape,
                                            mat.num_classes],
                     "kernel": k4_instance(mat)})
    emit({"phase": "kernels_check_mat", "batches": list(K4_TOFINO_BATCHES),
          "planted": ["edge values", "nan", "inf", "-inf", "-0.0", "0.0"],
          "mats": rows, "max_abs_err": worst})
    return worst


def launch_floor(dev) -> dict:
    """A one-element ``torch.zeros`` on the card: its wrapper ms (CUDA
    events over 50 calls) and the device ms of its fill kernel."""
    import torch

    fill = lambda: torch.zeros(1, device=dev)  # noqa: E731
    return {"ms": time_ms(fill, TIMED_LAUNCHES),
            "kernel_ms": call_device_ms(fill)}


def mat_timing(dev, mat, x) -> dict:
    """K4 on x: wrapper ms, device ms, the plain version's ms, the bound."""
    from repro_torch.kernels import mat_lut as ml

    (B, F), E = x.shape, mat.edges.shape[1]
    C = mat.num_classes
    mat_bytes = 4 * (mat.edges.numel() + mat.tables.numel()
                     + mat.lmap.numel())
    k4 = lambda: ml.mat_classify_launch(x, mat)  # noqa: E731
    name = k4_instance(mat)
    return dict(
        ms=time_ms(k4, TIMED_LAUNCHES),
        **kernel_fields(kernel_device_ms({name: k4})[name]),
        plain_ms=time_ms(lambda: ml.mat_classify_ref(
            x, mat.edges, mat.tables, mat.lmap), TIMED_LAUNCHES),
        bound=bound(B * F * 4 + mat_bytes + B * 4, B * F * (E + C)),
        kernel=name, B=B, features=F, edges=E, classes=C)


def timing(dev, stages, tp, sp, mlp, kw):
    """Each kernel's wrapper and its plain version on one flow-ddos batch
    (the stream's packets 4096..4607 against the table the first 4096
    packets leave).  The timed K1/K2 launches update one copy of that
    table in place, each applying the same batch again: the same
    segments and chains every launch.  K4 also runs at the Tofino shape
    (B = 1,024 and 2,048), beside the launch floor."""
    import numpy as np
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
    k1_name = K1_INSTANCE.format(kind=0, cap=1)
    k3_name = mlp_kernel_names(mlp.w_flat.numel())[0]
    dev_ms = kernel_device_ms({k1_name: k1, "flow_update_kernel": k2,
                               k3_name: k3})
    out = {}
    out["fused_flow_serve"] = dict(
        ms=time_ms(k1, TIMED_LAUNCHES),
        **kernel_fields(dev_ms[k1_name]),
        plain_ms=time_ms(lambda: ff.fused_flow_serve_ref(*ops, tp, sp, mlp),
                         3),
        bound=bound(rows + batch + params + B * 4,
                    upd_flops + live * (mlp_flops + W)), **shapes)
    out["flow_update"] = dict(
        ms=time_ms(k2, TIMED_LAUNCHES),
        **kernel_fields(dev_ms["flow_update_kernel"]),
        plain_ms=time_ms(lambda: fu.flow_update_ref(*ops, **kw), 3),
        bound=bound(rows + batch + B * W * 4, upd_flops), **shapes)
    out["fused_mlp_classify"] = dict(
        ms=time_ms(k3, TIMED_LAUNCHES),
        **kernel_fields(dev_ms[k3_name]),
        plain_ms=time_ms(lambda: fm.mlp_classify_ref(z, ws, bs),
                         TIMED_LAUNCHES),
        bound=bound(B * z.shape[1] * 4 + params + B * 4, B * mlp_flops),
        B=B, widths=list(mlp.widths))
    out["fused_flow_serve"]["modes"] = suffix_timing(
        dev, stages, ops, seg, tp, z, rows, batch, upd_flops, live, n_seg)
    mat = out["fused_flow_serve"]["modes"].pop("_mat")
    out["mat_lut_classify"] = mat_timing(dev, mat, z)
    tofino = tofino_mat(dev, 1, unsorted=False)
    rng = np.random.default_rng(7)
    out["mat_lut_classify"]["tofino"] = {
        f"B={n}": mat_timing(dev, tofino, torch.as_tensor(
            (rng.normal(size=(n, K4_TOFINO[0])) * 2).astype(np.float32),
            device=dev))
        for n in K4_TOFINO_TIMED}
    out["mat_lut_classify"]["launch_floor"] = launch_floor(dev)
    emit({"phase": "kernels_time", **{
        k: {kk: vv for kk, vv in v.items()} for k, v in out.items()}})
    return out


def suffix_timing(dev, stages, ops, seg, tp, z, rows, batch, upd_flops,
                  live, n_seg):
    """K1's other modes on the timing batch, each beside its plain version
    and its bound: "mat" (the mat-fused suffix), "centroid" (4
    centroids over 6 selected features), "mat+mitigation" (2,048 action
    slots: the flow segmentation is reused) and "mlp+mitigation" (4,096
    slots: the action table's own segmentation, made once before the
    timed launches like the flow segmentation).  The action tables are
    the ones the stream's first 4,096 packets leave.  -> {mode:
    numbers}, plus "_mat": the packed MAT for K4's timing."""
    import numpy as np
    import torch

    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import mat_lut as ml
    from repro_torch.kernels.flow_update.ops import segment_batch
    from repro_torch.testing import he_mlp, mat_stages

    B, W = z.shape[0], tp.width
    mst = mat_stages(W)
    mat = ml.pack_mat(mst[0].edges, mst[1].tables, mst[3].table, device=dev)
    rng = np.random.default_rng(11)
    cent = (rng.random((4, 6)) * np.asarray([40, 1, 1, 1, 1, 1])
            ).astype(np.float32)
    cents = ff.pack_centroids(cent, [0, 1, 0, 1], (0, 2, 4, 5, 9, 12),
                              use_min=True, device=dev)
    mlp = fm.pack_params(stages[3].weights, stages[3].biases, device=dev)
    F, E = mat.edges.shape
    mat_ops = live * (F * (E + mat.num_classes) + W)
    mat_bytes = 4 * (mat.edges.numel() + mat.tables.numel()
                     + mat.lmap.numel())
    mlp_bytes = 4 * (mlp.w_flat.numel() + mlp.b_flat.numel())
    mlp_ops = live * (2 * sum(a * b for a, b in zip(mlp.widths[:-1],
                                                    mlp.widths[1:])) + W)
    full = fm.pack_params(*he_mlp((W,) + FULL_HIDDEN + (2,), seed=0),
                          device=dev)
    full_bytes = 4 * (full.w_flat.numel() + full.b_flat.numel())
    full_ops = live * (2 * sum(a * b for a, b in zip(full.widths[:-1],
                                                     full.widths[1:])) + W)
    pk, valid = ops[2], ops[5]
    out = {}

    def mit_state(sm, sp, params, plan):
        """The action table after the stream's first 4,096 packets."""
        from repro_torch.data import traffic

        fk, ru = stages[:2]
        pkts = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                   seed=STREAM_SEED).packets
        st = (torch.full((S_KERNEL,), -1, dtype=torch.int32, device=dev),
              torch.zeros((S_KERNEL, W), device=dev),
              torch.full((sm,), -1, dtype=torch.int32, device=dev),
              torch.zeros((sm, 2), device=dev))
        for s in range(0, 4096, B_KERNEL):
            x = torch.as_tensor(pkts[s:s + B_KERNEL], device=dev)
            upd, bins = ru.prepare(x)
            st = ff.fused_flow_serve(
                st[0], st[1], fk.apply_keys(x), upd, bins,
                torch.ones(B_KERNEL, dtype=torch.int32, device=dev), tp, sp,
                params, mit=(st[2], st[3], plan))[:4]
        return st[2], st[3]

    for mode, sp, params, sm, pbytes, pops in (
            ("mat", ff.SuffixPlan("mat", 4), mat, None, mat_bytes, mat_ops),
            ("centroid", ff.SuffixPlan("centroid", 4), cents, None,
             4 * (cents.cent.numel() + cents.fidx.numel()
                  + cents.lmap.numel()), live * (3 * 4 * 6 + W)),
            ("mat+mitigation", ff.SuffixPlan("mat", 4), mat, MIT_SLOTS,
             mat_bytes, mat_ops),
            ("mlp+mitigation", ff.SuffixPlan("mlp", 2), mlp, AD_MIT_SLOTS,
             mlp_bytes, mlp_ops),
            ("mlp_full", ff.SuffixPlan("mlp", 2), full, None, full_bytes,
             full_ops)):
        table = ops[0].clone(), ops[1].clone()
        mit = mseg = None
        extra_b, extra_o, shape = 0, 0, {}
        if sm is not None:
            plan = ff.MitigationSpec(
                n_slots=sm, threshold=MIT_THRESHOLD if sm == MIT_SLOTS
                else AD_THRESHOLD, keep_every=AD_KEEP_EVERY)
            mk, mr = mit_state(sm, sp, params, plan)
            mit = (mk, mr, plan)
            mseg = ff.mitigation_segments(pk, valid, seg, S_KERNEL, sm)
            n_mseg = int((mseg.seg_len > 0).sum())
            # touched action rows and keys read and written once; the
            # segment tables when they are the action table's own
            extra_b = 2 * n_mseg * 3 * 4 + (
                0 if sm == S_KERNEL else live * 4 + B * 4 + n_mseg * 8)
            extra_o = 6 * live
            shape = {"mit_slots": sm, "mit_segments": n_mseg,
                     "max_mit_chain": int(mseg.seg_len.max())}

        def k1(_t=table, _sp=sp, _p=params, _m=mit, _ms=mseg):
            return ff.fused_flow_serve_launch(*_t, *ops[2:], seg, tp, _sp,
                                              _p, _m, _ms)

        def plain(_sp=sp, _p=params, _m=mit):
            return ff.fused_flow_serve_ref(*ops, tp, _sp, _p, _m)

        instance = K1_INSTANCE.format(kind=ff.SUFFIX_KINDS.index(sp.kind),
                                      cap=1)
        out[mode] = dict(
            ms=time_ms(k1, TIMED_LAUNCHES),
            **kernel_fields(kernel_device_ms({instance: k1})[instance]),
            plain_ms=time_ms(plain, 3),
            bound=bound(rows + batch + pbytes + B * 4 + extra_b,
                        upd_flops + pops + extra_o), **shape)
    # the split path's classifier at full width on the same readout rows:
    # K2 + this against "mlp_full" decides the fuse advice
    k3 = lambda: fm.fused_mlp_classify_launch(z, full)
    k3_name = mlp_kernel_names(full.w_flat.numel())[0]
    out["mlp_full"]["k3_kernel_ms"] = kernel_device_ms(
        {k3_name: k3})[k3_name]["ms"]
    out["_mat"] = mat
    return out


CHAIN_DEPTHS = (1, 135, 512)


def chain_timing(dev):
    """The slot chain's cost: K1 (the flow-ddos table and MLP, one table)
    and K2 at B = 512 on batches whose deepest slot chain is 1, 135 and
    512 packets (one flow for the deep chain, every other packet alone in
    a slot of its own, the arrival order shuffled, histogram bins as
    RegisterUpdate makes them), each kernel's device
    time (profiler, 20 launches applying the batch again to one copy of
    the table) and the slope between the shallowest and the deepest
    batch: the device ns a chain step costs.  Beside it, a model of the
    chain's latency floor, not a measurement: the four dependent
    operations an EWMA column's step keeps (r - r*alpha as one FFMA, the
    select on the column's kind, the add of the term, the select on the
    eviction flag) at 4 cycles each at the card's maximum SM clock
    (nvidia-smi's clocks.max.sm, a setting, not a reading)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flow_update as fu
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import flow_batch, slot_groups

    stages = flow_ddos_stages(S_KERNEL)
    spec = stages[1].spec
    mlp = fm.pack_params(stages[3].weights, stages[3].biases, device=dev)
    tp = table_plan(spec, "all")
    sp = ff.SuffixPlan("mlp", mlp.num_classes)
    kw = dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
              alpha=spec.ewma_alpha)
    k1_name = K1_INSTANCE.format(kind=0, cap=1)
    rows = {}
    for d in CHAIN_DEPTHS:
        rng = np.random.default_rng(d)
        b = flow_batch(spec, "all_distinct", B_KERNEL, seed=700 + d,
                       dup_bins=False)
        keys = np.concatenate(slot_groups(B_KERNEL - d + 1, 1, S_KERNEL,
                                          S_KERNEL))
        b["pkt_keys"] = rng.permutation(np.concatenate(
            [np.full(d, keys[0]), keys[1:]])).astype(np.int32)
        t = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        empty = (torch.full((S_KERNEL,), -1, dtype=torch.int32, device=dev),
                 torch.zeros((S_KERNEL, spec.width), device=dev))
        *ops, seg = fu.ops.prepare_operands(*empty, t["pkt_keys"], t["upd"],
                                            t["bins"], t["valid"])
        check(int(seg.seg_len.max()) == d,
              f"chain timing: deepest chain {int(seg.seg_len.max())} != {d}")
        table = ops[0].clone(), ops[1].clone()
        k1 = (lambda _t=table, _o=ops, _s=seg: ff.fused_flow_serve_launch(
            *_t, *_o[2:], _s, tp, sp, mlp))
        k2 = (lambda _t=table, _o=ops, _s=seg: fu.flow_update_launch(
            *_t, *_o[2:], _s, **kw))
        seen = kernel_device_ms({k1_name: k1, "flow_update_kernel": k2})
        rows[d] = {"fused_flow_serve": seen[k1_name]["ms"],
                   "flow_update": seen["flow_update_kernel"]["ms"],
                   "events": [seen[k1_name]["events"],
                              seen["flow_update_kernel"]["events"]]}
    lo, hi = CHAIN_DEPTHS[0], CHAIN_DEPTHS[-1]
    slope = {k: (rows[hi][k] - rows[lo][k]) * 1e6 / (hi - lo)
             if rows[hi][k] is not None and rows[lo][k] is not None
             else None for k in ("fused_flow_serve", "flow_update")}
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    mhz = float(r.stdout.split()[0]) if r.stdout.strip() else None
    floor = 4 * 4 / mhz * 1e3 if mhz else None      # ns per step
    emit({"phase": "kernels_time_chain", "B": B_KERNEL, "n_slots": S_KERNEL,
          "W": spec.width, "depths": list(CHAIN_DEPTHS),
          "device_ms": {str(d): v for d, v in rows.items()},
          "ns_per_step": slope, "sm_mhz_max": mhz,
          "chain_floor_model_ns_per_step": floor})
    return {"ns_per_step": slope,
            "device_ms": {str(d): v for d, v in rows.items()}}


def split_action_table_phase(dev):
    """The split path's action table, ``mitigate_update_segmented`` (plain
    PyTorch on the card), eager and as the split path serves it (the
    function ``cuda_backend.lower_mitigation`` returns: a CUDA graph
    replayed per batch), against the sequential walk on the card at the
    mitigate-fused (2,048 slots, threshold 6) and attack/defense (4,096,
    threshold 8) settings in both modes: collision patterns of
    ``repro_torch.testing`` keyed over the action table, 80 % attack
    verdicts, three chained 512-packet batches (the second ragged) from
    an empty table; keys, rows and verdicts exact.  Every eager call
    runs under ``torch.cuda.set_sync_debug_mode("error")``, so a host
    sync in it fails the phase.  Times all three per batch (CUDA
    events)."""
    import numpy as np
    import torch

    from repro_torch.core import cuda_backend, stageir
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.testing import flow_batch

    spec = flow_ddos_stages(S_KERNEL)[1].spec
    rows, dropped = [], 0
    for i, (sm, thr, mode, pattern) in enumerate(
            (sm, thr, mode, pattern)
            for sm, thr in ((MIT_SLOTS, MIT_THRESHOLD),
                            (AD_MIT_SLOTS, AD_THRESHOLD))
            for mode in ("drop", "rate_limit")
            for pattern in ("slot_runs", "one_hot_flow")):
        mit = ff.MitigationSpec(n_slots=sm, mode=mode, threshold=thr,
                                keep_every=AD_KEEP_EVERY)
        graphed, _ = cuda_backend.lower_mitigation(stageir.Mitigate(mit))
        sk = wk = gk = torch.full((sm,), -1, dtype=torch.int32, device=dev)
        sr = wr = gr = torch.zeros((sm, 2), device=dev)
        rng = np.random.default_rng(300 + i)
        for step in range(3):
            b = flow_batch(spec, pattern, B_KERNEL, seed=300 + 3 * i + step,
                           ragged=step == 1, key_slots=sm)
            args = [torch.as_tensor(a, device=dev) for a in (
                b["pkt_keys"], (rng.random(B_KERNEL) < 0.8).astype(np.int32),
                b["valid"])]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sk, sr, sv = ff.mitigate_update_segmented(sk, sr, *args,
                                                          spec=mit)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            gk, gr, gv = graphed(gk, gr, *args)
            wk, wr, wv = ff.mitigate_update(wk, wr, *args, spec=mit)
            name = f"split action table {sm} {mode} {pattern} step {step}"
            for k, r, v, form in ((sk, sr, sv, "eager"),
                                  (gk, gr, gv, "graphed")):
                check(torch.equal(k, wk) and torch.equal(
                    r.view(torch.int32), wr.view(torch.int32)),
                    f"{name}: {form} table differs from the walk")
                check(torch.equal(v, wv), f"{name}: {form} verdicts differ")
            dropped += int((sv == ff.MITIGATED).sum())
        rows.append({
            "mit_slots": sm, "mode": mode, "pattern": pattern,
            "graphed_ms": time_ms(lambda: graphed(gk, gr, *args),
                                  TIMED_LAUNCHES),
            "eager_ms": time_ms(lambda: ff.mitigate_update_segmented(
                sk, sr, *args, spec=mit), TIMED_LAUNCHES),
            "walk_ms": time_ms(lambda: ff.mitigate_update(
                wk, wr, *args, spec=mit), 10)})
    check(dropped > 0, "split action table: no packet was mitigated")
    emit({"phase": "split_action_table", "B": B_KERNEL,
          "dropped_pkts": dropped, "rows": rows})


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
    check(launches == dict.fromkeys(_ext.LAUNCHES, 0) | {
              "fused_flow_serve": n_fused, "flow_update": n_split,
              "fused_mlp_classify": n_split},
          f"{name}: launches {launches} != batches "
          f"(fused {n_fused}, split {n_split})")
    emit({"phase": name, "n_slots": n_slots, "n_packets": n_packets,
          "plain_walk_s": plain_s, "rows": rows, "launches": launches,
          "batches": {"fused": n_fused, "split": n_split}})
    return launches


def serve_stages(stages, backend, fuse, max_batch, stream, dev,
                 swap_at=None):
    """One engine over the whole stream -> (verdicts, engine).  With
    ``swap_at`` the stream is submitted chunk by chunk, flushing each,
    and at chunk ``swap_at`` the engine hot-swaps to a new, identical
    pipeline (the swap-under-rate-limit run of attack_defense.py)."""
    import numpy as np

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.serve.packet_engine import PacketServeEngine

    pipe = StatefulPipeline(stages, backend=backend, fuse=fuse,
                            device=dev.type)
    eng = PacketServeEngine(pipe, feature_dim=len(traffic.COLUMNS),
                            max_batch=max_batch, depth=2, device=dev.type)
    if swap_at is None:
        return np.concatenate(list(eng.serve_stream(
            stream.chunks(max_batch)))), eng
    got = []
    for i, c in enumerate(stream.chunks(max_batch)):
        if i == swap_at:
            check(eng.state.mitigated_flows > 0,
                  "the swap must land while flows are being rate-limited")
            eng.swap(StatefulPipeline(stages, backend=backend, fuse=fuse,
                                      device=dev.type))
        eng.submit(c)
        got.append(eng.flush())
    return np.concatenate(got), eng


def row_of(eng) -> dict:
    st = eng.stats()
    return {k: st[k] for k in ("backend", "pkt_per_s", "lat_p50_ms",
                               "lat_p99_ms", "dispatch_s", "wall_s",
                               "batches", "mitigated")}


def mat_path_phase(dev, name: str, mitigated: bool, batches=(256, 512),
                   repeats: int = 3, counts=None):
    """path_mat_fused / path_mitigate_fused: the stream on
    backend="cuda", fused (K1) and split (K2 + K4, the action table in
    plain PyTorch on the card), held bit for bit against
    backend="interpret".  ``counts`` collects each engine's telemetry
    counter of mitigated packets beside its MITIGATED verdicts."""
    import numpy as np
    import torch

    from repro_torch.data import traffic
    from repro_torch.kernels import _ext

    stages = mat_fused_stages(S_KERNEL, mitigated)
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                 seed=STREAM_SEED)
    _ext.reset_launches()
    iv, ieng = serve_stages(stages, "interpret", True, max(batches), stream,
                            dev)
    check(sum(_ext.LAUNCHES.values()) == 0,
          f"{name}: the interpret backend launched a kernel")
    want_state = state_arrays(ieng.state)
    rows = [dict(row_of(ieng), max_batch=max(batches))]
    base = "cuda" if dev.type == "cuda" else "cpu-ref"
    split_name = "mixed" if mitigated else base
    _ext.reset_launches()
    n_fused = n_split = 0
    for max_batch in batches:
        for fuse in (True, False):
            runs = []
            for _ in range(repeats):
                v, eng = serve_stages(stages, "cuda", fuse, max_batch,
                                      stream, dev)
                check(np.array_equal(v, iv),
                      f"{name}: {eng.backend} verdicts differ from interpret")
                check(all(np.array_equal(a, b) for a, b in zip(
                    state_arrays(eng.state), want_state)),
                    f"{name}: {eng.backend} tables differ from interpret")
                check(eng.backend == (f"{base}-fused-flow" if fuse
                                      else split_name),
                      f"{name}: backend {eng.backend}")
                runs.append(row_of(eng))
                if mitigated and counts is not None:
                    snap = eng.telemetry().snapshot()
                    counts.append((snap["serve_mitigated_packets_total"][
                        "values"][0]["value"], int((v == -1).sum())))
                n = runs[-1]["batches"] + 1        # + the warm-up batch
                n_fused, n_split = ((n_fused + n, n_split) if fuse
                                    else (n_fused, n_split + n))
            med = sorted(runs, key=lambda r: r["pkt_per_s"])[len(runs) // 2]
            rows.append(dict(med, max_batch=max_batch, depth=2,
                             pkt_per_s_runs=sorted(r["pkt_per_s"]
                                                   for r in runs)))
    launches = dict(_ext.LAUNCHES)
    torch.cuda.synchronize()
    check(launches == dict.fromkeys(_ext.LAUNCHES, 0) | {
              "fused_flow_serve": n_fused, "flow_update": n_split,
              "mat_lut_classify": n_split},
          f"{name}: launches {launches} != batches "
          f"(fused {n_fused}, split {n_split})")
    report = traffic.reaction_report(stream, iv)
    dropped = int((iv == -1).sum())
    if mitigated:
        check(dropped > 0, f"{name}: no packet was mitigated")
    emit({"phase": name, "n_slots": S_KERNEL, "n_packets": N_PACKETS,
          "mit_slots": MIT_SLOTS if mitigated else None, "rows": rows,
          "launches": launches, "batches": {"fused": n_fused,
                                            "split": n_split},
          "mitigated_pkts": dropped,
          "reaction": {k: report[k] for k in (
              "attack_flows", "detection_rate", "mitigated_flows",
              "mitigation_lag_median", "leaked_pkts_total",
              "benign_mitigated_flow_rate")}})
    return launches


def attack_defense_phase(dev):
    """The three flood scenarios, drop mode, fused (K1) against
    interpret: identical verdicts and tables, MITIGATED verdicts, zero
    leaked packets.  syn_flood also runs split (K2 + K3 and the action
    table's plain device form, "mixed") against the same interpret run.
    Then the swap-under-rate-limit run on syn_flood.  Each run's
    launches are counted from 0 and held to the batches it served: one
    K1 per fused batch, one K2 and one K3 per split batch, plus the
    engine's warm-up batch and the swap's."""
    import numpy as np

    from repro_torch.data import traffic
    from repro_torch.kernels import _ext

    base = "cuda" if dev.type == "cuda" else "cpu-ref"
    rows, launches = [], {k: 0 for k in _ext.LAUNCHES}

    def counted(stages, fuse, stream, extra=1, **kw):
        """One served run, its launches held to its batches."""
        _ext.reset_launches()
        v, eng = serve_stages(stages, "cuda", fuse, AD_BATCH, stream, dev,
                              **kw)
        got = dict(_ext.LAUNCHES)
        n = eng.stats()["batches"] + extra
        want = {k: 0 for k in got}
        want.update({"fused_flow_serve": n} if fuse else
                    {"flow_update": n, "fused_mlp_classify": n})
        check(got == want, f"attack_defense: launches {got} != {want}")
        for k, c in got.items():
            launches[k] += c
        return v, eng

    for scenario in AD_SCENARIOS:
        stages = attack_defense_stages(scenario)
        stream = traffic.make_stream(scenario, n_packets=AD_PACKETS,
                                     seed=STREAM_SEED)
        _ext.reset_launches()
        iv, ieng = serve_stages(stages, "interpret", True, AD_BATCH, stream,
                                dev)
        check(sum(_ext.LAUNCHES.values()) == 0,
              f"{scenario}: the interpret backend launched a kernel")
        for fuse in (True, False) if scenario == "syn_flood" else (True,):
            v, eng = counted(stages, fuse, stream)
            want = f"{base}-fused-flow" if fuse else "mixed"
            check(eng.backend == want,
                  f"{scenario}: backend {eng.backend} != {want}")
            check(np.array_equal(v, iv),
                  f"{scenario}: {want} verdicts differ from interpret")
            check(all(np.array_equal(a, b) for a, b in zip(
                state_arrays(eng.state), state_arrays(ieng.state))),
                f"{scenario}: {want} tables differ from interpret")
            rep = traffic.reaction_report(stream, v)
            check(int((v == -1).sum()) > 0, f"{scenario}: nothing mitigated")
            check(rep["leaked_pkts_total"] == 0,
                  f"{scenario}: {rep['leaked_pkts_total']} packets leaked")
            rows.append(dict(row_of(eng), scenario=scenario,
                             interpret_pkt_per_s=ieng.stats()["pkt_per_s"],
                             **{k: rep[k] for k in (
                                 "attack_flows", "detection_rate",
                                 "mitigated_flows", "mitigation_lag_median",
                                 "mitigation_lag_p95", "leaked_pkts_total",
                                 "benign_mitigated_flow_rate")}))
    # swap while flows are rate-limited: same verdicts, exactly one swap
    stages = attack_defense_stages("syn_flood", mode="rate_limit")
    stream = traffic.make_stream("syn_flood", n_packets=AD_PACKETS,
                                 seed=STREAM_SEED)
    ref, _ = counted(stages, True, stream)
    n_chunks = -(-AD_PACKETS // AD_BATCH)
    v, eng = counted(stages, True, stream, extra=2, swap_at=n_chunks // 2)
    check(np.array_equal(v, ref), "the hot swap perturbed the mitigation "
          "stream")
    check(eng.stats()["swaps"] == 1, "expected exactly one swap")
    swap = {"dropped_pkts": int((v == -1).sum()),
            "mitigated_flows": eng.state.mitigated_flows,
            "swaps": eng.stats()["swaps"],
            "swap_lat_ms": eng.stats()["swap_lat_ms"],
            "swap_pkt_offsets": eng.stats()["swap_pkt_offsets"]}
    emit({"phase": "attack_defense", "n_packets": AD_PACKETS,
          "mit_slots": AD_MIT_SLOTS, "threshold": AD_THRESHOLD,
          "max_batch": AD_BATCH, "rows": rows,
          "swap_under_rate_limit": swap, "launches": launches,
          "nvidia_smi": nvidia_smi()})
    return launches


def profile_phase(dev, name: str, pipe, chunks, feature_dim: int,
                  max_batch: int = 512):
    """Where the time goes on a path: the device's busy time (sum of
    kernel and copy durations, from torch.profiler) against the
    unprofiled serving wall time, CUDA launches per batch, and the host
    operations that take the most CPU time.  ``chunks()`` gives the
    stream's chunks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.packet_engine import PacketServeEngine

    def run():
        eng = PacketServeEngine(pipe, feature_dim=feature_dim,
                                max_batch=max_batch, depth=2,
                                device=dev.type)
        for _ in eng.serve_stream(chunks()):
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
    emit({"phase": "profile", "path": name, "max_batch": max_batch,
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


# ------------------------------------------------ stateless DAG (slice 3)

AD_N_TRAIN, AD_N_TEST, AD_FEATURES = 4096, 8192, 7
DAG_CHUNK, DAG_PASSES, DAG_BATCHES = 997, 3, (128, 256, 1024, 4096)
DAG_TIME_B = 1024
# slice 10: the full-width K3, K5 and K6 are timed at path_dag's batch
# sizes; the tile kernels are checked at the design space's full-width
# DNN with 7, 30 and 47 inputs, a 256-wide model, 16 layers and a 1-wide
# input, on batches either side of tile and chunk edges
DAG_TIME_FULL = (128, 1024, 4096)
TILE_WIDTHS = {"full7": (7,) + FULL_HIDDEN + (2,),
               "full30": (30,) + FULL_HIDDEN + (2,),
               "full47": (47,) + FULL_HIDDEN + (2,),
               "w256": (64, 256, 256, 10), "deep16": (20,) + (48,) * 15 + (3,),
               "tiny": (1, 4, 2)}
TILE_BATCHES = (1, 31, 37, 128, 1024, 4096, 8192)
TILE_K_CHUNK = 64                  # mlp_tile_ref's chunk of input rows


def tile_rows(B: int, dev) -> int:
    """The rows of a tile the kernels take at B rows (``mt_config``): the
    power of two covering B / (the card's SMs), at most TILE_ROWS."""
    import torch

    from repro_torch.kernels import fused_mlp as fm

    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 132)
    rows = 1
    while rows * n_sm < B and rows < fm.TILE_ROWS:
        rows *= 2
    return rows


def tile_inputs(d0: int, B: int, X):
    """B rows of width d0: the AD test set's for 7 features, else seeded
    N(0, 4) rows."""
    import numpy as np

    if d0 == AD_FEATURES:
        return X[:B]
    return (np.random.default_rng(d0).normal(size=(B, d0)) * 2
            ).astype(np.float32)


def ad_test_set():
    """The AD test set (``benchmarks/dag_throughput.py:62``), f32."""
    import numpy as np

    from repro_torch.data import netdata

    return netdata.make_ad_dataset(features=AD_FEATURES, n_train=AD_N_TRAIN,
                                   n_test=AD_N_TEST).test_x.astype(np.float32)


def dag_models(dev):
    """The AD DAG's seeded pipelines (``testing.ad_pipelines``) on ``dev``
    and on the CPU (the plain reference), plus a leaf "fs" that selects
    features [1, 3, 6] before a Dense [3, 2] + argmax (the fold into K6's
    first layer)."""
    import numpy as np

    from repro_torch.core import stageir
    from repro_torch.testing import ad_pipelines, he_mlp

    w, b = he_mlp((3, 2), seed=9)
    fs = [stageir.FeatureSelect(np.asarray([1, 3, 6], np.int32)),
          stageir.Dense(w[0], b[0]), stageir.Reduce("argmax")]
    out = []
    for d in (dev, "cpu"):
        pipes = ad_pipelines(d)
        pipes["fs"] = stageir.StagePipeline(fs, device=d)
        out.append(pipes)
    return out


def dag_nodes() -> dict:
    """The DAGs of the smoke: Seq, Par (or / and), the nested one with a
    repeated model, the FeatureSelect fold, the mixed one (a centroid
    leaf) and the full-width one."""
    from repro_torch.core.alchemy import Model

    ad, tc, cl, full, fs = (Model(n) for n in ("ad", "tc", "cl", "ad_full",
                                                "fs"))
    return {"ad>tc": ad > tc, "ad|tc": ad | tc, "ad>(tc|ad)": ad > (tc | ad),
            "ad>fs": ad > fs, "ad>(tc|cl)": ad > (tc | cl),
            "ad_full>tc": full > tc}


def dag_leaf_verdicts(dag, x):
    """Each model of a packed DAG through K3 -> [verdicts]."""
    from repro_torch.kernels import fused_mlp as fm

    return [fm.fused_mlp_classify_launch(x, fm.pack_params(w, b))
            for w, b in dag.models()]


def kernels_check_dag(dev):
    """K5 and K6 against their plain versions on the card, at B = 1, 37,
    1024 and 8192 rows of the AD test set: K5's logits within 1e-4 * (1 +
    |plain|) at the AD widths, the SVM and full width; K6 on every plan
    (seq, or, and, the nested DAG with a repeated model, a folded
    FeatureSelect, full width) — its fold exact given the per-model K3
    verdicts, its verdicts under the margin rule against the plain
    ``fused_dag`` on CPU tensors (a row is excluded when any leaf's
    top-two margin is within 1e-4).  Then the tile kernels' cases
    (``tile_checks``).  -> max abs error per kernel."""
    import numpy as np
    import torch

    from repro_torch.core import cuda_backend
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import (
        AD_FULL_WIDTHS,
        AD_WIDTHS,
        he_mlp,
        leaf_margin_rows,
    )

    X = ad_test_set()
    pipes, cpu_pipes = dag_models(dev)
    err = {"fused_mlp": 0.0, "fused_dag": 0.0}
    sizes = (1, 37, 1024, 8192)
    mlps = {"ad": he_mlp(AD_WIDTHS, 0), "svm": he_mlp((7, 2), 1),
            "ad_full": he_mlp(AD_FULL_WIDTHS, 2)}
    for name, (w, b) in mlps.items():
        p = fm.pack_params(w, b, device=dev)
        for B in sizes:
            x = torch.as_tensor(X[:B], device=dev)
            got = fm.fused_mlp_launch(x, p)
            want = fm.mlp_ref(x, *p.layers())
            torch.cuda.synchronize()
            check(bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all()),
                  f"K5 logits differ on {name} at B={B}")
            err["fused_mlp"] = max(err["fused_mlp"], max_abs(got, want))
    plans = []
    for text, node in dag_nodes().items():
        combines = ("or", "and") if text == "ad|tc" else ("or",)
        for combine in combines:
            if text == "ad>(tc|cl)":
                check(cuda_backend.dag_decline_reason(
                    node, pipes, combine=combine) is not None,
                    "a centroid leaf must not fuse")
                continue
            plan, folded, reason = cuda_backend._prepare_dag(
                node, pipes, combine, True)
            check(reason is None, f"{text}: {reason}")
            dag = fm.pack_dag(folded, plan, device=dev)
            cpu_dag = fm.pack_dag(folded, plan)
            plans.append(f"{text}/{combine}")
            if text == "ad>(tc|ad)":
                check(dag.n_models == 2, "the repeated model staged twice")
            for B in sizes:
                x = torch.as_tensor(X[:B], device=dev)
                got = fm.fused_dag_launch(x, dag)
                folded_v = fm.eval_dag_program(dag.program,
                                               dag_leaf_verdicts(dag, x))
                plain = fm.fused_dag(x.cpu(), cpu_dag).numpy()
                torch.cuda.synchronize()
                check(torch.equal(got, folded_v),
                      f"K6 fold differs on {text} at B={B}")
                close = leaf_margin_rows(
                    [cpu_pipes[m.name] for m in node.leaves()], X[:B])
                bad = int(((got.cpu().numpy() != plain) & ~close).sum())
                check(bad == 0, f"K6: {bad} verdicts differ on {text} "
                      f"at B={B}")
                err["fused_dag"] = max(err["fused_dag"], float(np.abs(
                    got.cpu().numpy() - plain)[~close].max(initial=0)))
    tiles = tile_checks(dev, X, err)
    emit({"phase": "kernels_check_dag", "batches": list(sizes),
          "k5_models": {k: [int(w[0].shape[0])] + [int(a.shape[1])
                                                    for a in w]
                        for k, (w, _) in mlps.items()},
          "k6_plans": plans, "tile": tiles, "max_abs_err": err})
    return err


def tile_checks(dev, X, err: dict) -> dict:
    """K3, K5 and K6 at the tile kernels' edges: every model of
    TILE_WIDTHS at every TILE_BATCHES size, and the DAGs ``ad_full > tc``
    and two full-width models under "or" (neither staged whole).  K5's
    logits within 1e-4 * (1 + |ref|) and K3's verdicts under the margin
    rule, against the plain version and against ``mlp_tile_ref`` (the
    kernels' schedule written out: tiles of the kernels' rows, chunks of
    TILE_K_CHUNK input rows); K6's fold exact given the per-model K3
    verdicts, its verdicts under the margin rule against the plain
    ``fused_dag`` and against the fold of ``mlp_tile_ref``'s verdicts.
    Updates K5's ``err``.  -> the cases and the rows within the margin
    (excluded from the verdict checks)."""
    import torch

    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import MARGIN, he_mlp, verdict_mismatches

    out = {"models": {k: list(w) for k, w in TILE_WIDTHS.items()},
           "batches": list(TILE_BATCHES), "cases": 0, "close_rows": 0}

    def refs(x, ws, bs, B):
        return (("plain", fm.mlp_ref(x, ws, bs)),
                ("mlp_tile_ref", fm.mlp_tile_ref(x, ws, bs, tile_rows(B, dev),
                                                 TILE_K_CHUNK)))

    for key, widths in TILE_WIDTHS.items():
        p = fm.pack_params(*he_mlp(widths, seed=len(widths)), device=dev)
        ws, bs = p.layers()
        for B in TILE_BATCHES:
            x = torch.as_tensor(tile_inputs(widths[0], B, X), device=dev)
            logits = fm.fused_mlp_launch(x, p)
            v = fm.fused_mlp_classify_launch(x, p)
            for what, ref in refs(x, ws, bs, B):
                torch.cuda.synchronize()
                check(bool(((logits - ref).abs()
                            <= 1e-4 * (1 + ref.abs())).all()),
                      f"K5 logits differ from {what} on {key} at B={B}")
                bad, close = verdict_mismatches(v.cpu().numpy(),
                                                ref.cpu().numpy())
                check(bad == 0, f"K3: {bad} verdicts differ from {what} "
                      f"on {key} at B={B}")
                if what == "plain":
                    err["fused_mlp"] = max(err["fused_mlp"],
                                           max_abs(logits, ref))
                    out["close_rows"] += close
            out["cases"] += 1
    full, tc = TILE_WIDTHS["full7"], (AD_FEATURES, 2)
    dags = {"ad_full>tc": ([full, tc], ("seq", (("model", 0), ("model", 1)))),
            "full|full": ([full, full], ("or", (("model", 0), ("model", 1))))}
    for name, (widths, plan) in dags.items():
        models = [he_mlp(w, seed=11 + i) for i, w in enumerate(widths)]
        dag = fm.pack_dag(models, plan, device=dev)
        check(fm.tiled(dag.w_flat.numel()), f"{name} must stream")
        for B in TILE_BATCHES:
            x = torch.as_tensor(X[:B], device=dev)
            got = fm.fused_dag_launch(x, dag)
            leaves = dag_leaf_verdicts(dag, x)
            check(torch.equal(got, fm.eval_dag_program(dag.program, leaves)),
                  f"K6 fold differs on {name} at B={B}")
            mws = [(ws, bs) for ws, bs in dag.models()]
            plain = [fm.mlp_ref(x, ws, bs) for ws, bs in mws]
            tile = [fm.mlp_tile_ref(x, ws, bs, tile_rows(B, dev),
                                    TILE_K_CHUNK) for ws, bs in mws]
            close = torch.zeros(B, dtype=torch.bool, device=dev)
            for lg in plain:
                top = torch.topk(lg, 2, 1).values
                close |= (top[:, 0] - top[:, 1]) <= MARGIN
            for what, lgs in (("plain", plain), ("mlp_tile_ref", tile)):
                want = fm.eval_dag_program(
                    dag.program,
                    [lg.argmax(1).to(torch.int32) for lg in lgs])
                bad = int(((got != want) & ~close).sum())
                check(bad == 0, f"K6: {bad} verdicts differ from {what} on "
                      f"{name} at B={B}")
            out["cases"] += 1
            out["close_rows"] += int(close.sum())
    out["dags"] = list(dags)
    return out


def dag_timing(dev):
    """K5 and K6 (and K3 at full width) on slices of the AD test set, at
    the AD widths (B = 1,024) and at full width (B = 128, 1,024 and
    4,096, ``DAG_TIME_FULL``): wrapper ms over 50 calls (CUDA events),
    device ms (profiler, exact instance), the bound and the plain
    version's ms.  -> {kernel: {config: numbers}}, a config at B = 1,024
    under its name, at another B under "name@B"."""
    import torch

    from repro_torch.core import cuda_backend
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.testing import AD_FULL_WIDTHS, AD_WIDTHS, he_mlp

    X = ad_test_set()
    pipes, _ = dag_models(dev)
    nodes = dag_nodes()

    def mlp_work(widths):
        nparams = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
        return 4 * nparams, 2 * sum(a * b for a, b in zip(widths[:-1],
                                                          widths[1:]))

    def key(name, B):
        return name if B == DAG_TIME_B else f"{name}@{B}"

    out = {"fused_mlp": {}, "fused_dag": {}, "fused_mlp_classify": {}}
    for name, widths, seed, batches in (
            ("ad", AD_WIDTHS, 0, (DAG_TIME_B,)),
            ("ad_full", AD_FULL_WIDTHS, 2, DAG_TIME_FULL)):
        p = fm.pack_params(*he_mlp(widths, seed), device=dev)
        pbytes, flops = mlp_work(widths)
        ws, bs = p.layers()
        k3_name, k5_name, _ = mlp_kernel_names(p.w_flat.numel())
        for B in batches:
            x = torch.as_tensor(X[:B], device=dev)
            k5 = lambda _p=p, _x=x: fm.fused_mlp_launch(_x, _p)
            k3 = lambda _p=p, _x=x: fm.fused_mlp_classify_launch(_x, _p)
            seen = kernel_device_ms({k5_name: k5, k3_name: k3})
            out["fused_mlp"][key(name, B)] = dict(
                ms=time_ms(k5, TIMED_LAUNCHES), **kernel_fields(seen[k5_name]),
                plain_ms=time_ms(lambda _x=x: fm.mlp_ref(_x, ws, bs),
                                 TIMED_LAUNCHES),
                bound=bound(B * widths[0] * 4 + pbytes + B * widths[-1] * 4,
                            B * flops), B=B, widths=list(widths),
                kernel=k5_name)
            if name == "ad_full":
                out["fused_mlp_classify"][key(name, B)] = dict(
                    ms=time_ms(k3, TIMED_LAUNCHES),
                    **kernel_fields(seen[k3_name]),
                    plain_ms=time_ms(
                        lambda _x=x: fm.mlp_classify_ref(_x, ws, bs),
                        TIMED_LAUNCHES),
                    bound=bound(B * widths[0] * 4 + pbytes + B * 4,
                                B * flops), B=B, widths=list(widths),
                    kernel=k3_name)
    for text, batches in (("ad>tc", (DAG_TIME_B,)),
                          ("ad_full>tc", DAG_TIME_FULL)):
        plan, folded, _ = cuda_backend._prepare_dag(nodes[text], pipes, "or",
                                                    True)
        dag = fm.pack_dag(folded, plan, device=dev)
        models = [([w.to(dev) for w in ws], [b.to(dev) for b in bs])
                  for ws, bs in dag.models()]
        pbytes = 4 * (dag.w_flat.numel() + dag.b_flat.numel())
        flops = sum(mlp_work(w)[1] + w[-1] for w in dag.widths)
        k6_name = mlp_kernel_names(dag.w_flat.numel())[2]
        for B in batches:
            x = torch.as_tensor(X[:B], device=dev)
            k6 = lambda _d=dag, _x=x: fm.fused_dag_launch(_x, _d)
            out["fused_dag"][key(text, B)] = dict(
                ms=time_ms(k6, TIMED_LAUNCHES),
                **kernel_fields(kernel_device_ms({k6_name: k6})[k6_name]),
                plain_ms=time_ms(
                    lambda _x=x: fm.fused_dag_ref(_x, models, dag.program),
                    TIMED_LAUNCHES),
                bound=bound(B * dag.n_feat * 4 + pbytes + B * 4, B * flops),
                B=B, widths=[list(w) for w in dag.widths], kernel=k6_name)
    emit({"phase": "kernels_time_dag", **out, "nvidia_smi": nvidia_smi()})
    return out


def path_dag_phase(dev):
    """The AD test set (8,192 rows, chunks of 997, 3 passes) through
    ``PacketServeEngine(depth=2)`` at max_batch 128, 256, 1024 and 4096:
    (a) ``ad > tc`` fused (one K6 launch per batch), (b) the same with
    ``fuse_dag=False`` (one K3 per model per batch), (c) the same on
    ``backend="interpret", fuse=False`` (the stage walk, whose FusedMLP
    stage runs K5 as the JAX package's runs its Pallas kernel), (d) ``ad >
    (tc | cl)`` with a centroid leaf ("mixed": K3 per MLP model, the
    centroid walked) and (e) ``ad_full > tc`` fused.  Each against the
    plain walk on CPU tensors (which launches nothing) under the margin
    rule, launches held to batches.  The dispatches raise nothing under
    ``set_sync_debug_mode("error")``, nor do those of a logits program
    (``ad``'s FusedMLP alone on K5) and of a swap from it to (a).  Then a
    hot swap from (a) to (e) mid-stream."""
    import numpy as np
    import torch

    from repro_torch.core import chaining, stageir
    from repro_torch.kernels import _ext
    from repro_torch.serve.packet_engine import PacketServeEngine
    from repro_torch.testing import leaf_margin_rows

    X = ad_test_set()
    pipes, cpu_pipes = dag_models(dev)
    nodes = dag_nodes()
    base = "cuda" if dev.type == "cuda" else "cpu-ref"
    configs = {
        "a": ("ad>tc", dict(backend="cuda"), f"{base}-fused-dag",
              {"fused_dag": 1}),
        "b": ("ad>tc", dict(backend="cuda", fuse_dag=False), base,
              {"fused_mlp_classify": 2}),
        "c": ("ad>tc", dict(backend="interpret", fuse=False), "interpret",
              {"fused_mlp": 1}),
        "d": ("ad>(tc|cl)", dict(backend="cuda"), "mixed",
              {"fused_mlp_classify": 2}),
        "e": ("ad_full>tc", dict(backend="cuda"), f"{base}-fused-dag",
              {"fused_dag": 1}),
    }
    chunks = [X[i:i + DAG_CHUNK] for i in range(0, len(X), DAG_CHUNK)]
    _ext.reset_launches()
    ad_v = cpu_pipes["ad"](X)
    check(sum(_ext.LAUNCHES.values()) == 0, "the plain reference launched")
    check(0 < int((ad_v > 0).sum()) < len(X),
          "the Seq gate must flag some rows and pass others")
    rows, by_cfg, launches = [], {}, {k: 0 for k in _ext.LAUNCHES}
    for key, (text, kw, want_backend, per_batch) in configs.items():
        node = nodes[text]
        _ext.reset_launches()
        ref = chaining.run_dag(node, cpu_pipes, X)
        check(sum(_ext.LAUNCHES.values()) == 0,
              f"({key}) the plain reference launched a kernel")
        close = leaf_margin_rows([cpu_pipes[m.name] for m in node.leaves()],
                                 X)
        dag = chaining.compile_dag(node, pipes, device=dev.type, **kw)
        check(dag.backend == want_backend,
              f"({key}) backend {dag.backend} != {want_backend}")
        _ext.reset_launches()
        n_batches = 0
        for max_batch in DAG_BATCHES:
            runs = []
            for _ in range(DAG_PASSES):
                eng = PacketServeEngine(dag, feature_dim=AD_FEATURES,
                                        max_batch=max_batch, depth=2,
                                        device=dev.type)
                v = np.concatenate(list(eng.serve_stream(chunks)))
                bad = int(((v != ref) & ~close).sum())
                check(bad == 0, f"({key}) B={max_batch}: {bad} verdicts "
                      "differ from the plain walk")
                st = eng.stats()
                n_batches += st["batches"] + 1     # + the warm-up batch
                runs.append(st)
            med = sorted(runs, key=lambda r: r["pkt_per_s"])[len(runs) // 2]
            rows.append({"config": key, "dag": text, **kw,
                         "backend": med["backend"], "max_batch": max_batch,
                         "depth": 2, "pkt_per_s": med["pkt_per_s"],
                         "pkt_per_s_runs": sorted(r["pkt_per_s"]
                                                  for r in runs),
                         "lat_p50_ms": med["lat_p50_ms"],
                         "lat_p99_ms": med["lat_p99_ms"],
                         "dispatch_s": med["dispatch_s"],
                         "wall_s": med["wall_s"], "batches": med["batches"],
                         "margin_rows": int(close.sum())})
        got = dict(_ext.LAUNCHES)
        want = {k: per_batch.get(k, 0) * n_batches for k in got}
        check(got == want, f"({key}) launches {got} != {want}")
        for k, n in got.items():
            launches[k] += n
        by_cfg[key] = dag
    # the stateless dispatch makes no host sync
    def sync_checked(eng, rows):
        eng.submit(rows)
        torch.cuda.set_sync_debug_mode("error")
        try:
            while eng.pending:
                eng._dispatch_batch(eng._take(min(1024, eng.pending)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return eng.flush()

    for key, dag in by_cfg.items():
        eng = PacketServeEngine(dag, feature_dim=AD_FEATURES,
                                max_batch=1024, depth=2, device=dev.type)
        v = sync_checked(eng, X[:2048])
        check(np.array_equal(v, dag(X[:2048])),
              f"({key}) verdicts of the sync-checked dispatch differ")
    # a logits program (K5, [B, 2] f32 out), then a swap to (a)'s int32
    # verdicts: each staged in a ring sized at warm-up or at the swap
    logits_stages = cpu_pipes["ad"].stages[:1]
    logits = stageir.compile_stages(logits_stages, backend="cuda",
                                    device=dev.type)
    check(logits.backend == base, f"logits backend {logits.backend}")
    eng = PacketServeEngine(logits, feature_dim=AD_FEATURES,
                            max_batch=1024, depth=2, device=dev.type)
    v = sync_checked(eng, X[:2048])
    ref = stageir.StagePipeline(logits_stages, device="cpu")(X[:2048])
    check(v.shape == ref.shape == (len(ref), 2) and v.dtype == np.float32,
          f"logits served as {v.shape} {v.dtype}")
    check(bool((np.abs(v - ref) <= 1e-4 * (1 + np.abs(ref))).all()),
          "logits of the sync-checked dispatch differ from the plain walk")
    eng.swap(by_cfg["a"])
    v = sync_checked(eng, X[2048:4096])
    check(np.array_equal(v, by_cfg["a"](X[2048:4096])),
          "verdicts after the logits -> DAG swap differ")
    swap = dag_swap(dev, by_cfg["a"], by_cfg["e"], X)
    emit({"phase": "path_dag", "n_packets": len(X), "chunk": DAG_CHUNK,
          "passes": DAG_PASSES, "rows": rows, "launches": launches,
          "sync_debug": "error, no raise", "swap": swap,
          "gate_flagged": int((ad_v > 0).sum()),
          "nvidia_smi": nvidia_smi()})
    return launches


def dag_swap(dev, old, new, X):
    """A stateless hot swap mid-stream, from ``old`` to ``new``: verdicts
    before the boundary are ``old``'s, after it ``new``'s, one swap."""
    import numpy as np

    from repro_torch.serve.packet_engine import PacketServeEngine

    eng = PacketServeEngine(old, feature_dim=AD_FEATURES, max_batch=1024,
                            depth=2, device=dev.type)
    chunks = [X[i:i + DAG_CHUNK] for i in range(0, len(X), DAG_CHUNK)]
    half = len(chunks) // 2
    got = []
    for i, c in enumerate(chunks):
        if i == half:
            eng.swap(new)
        eng.submit(c)
        got.append(eng.flush())
    cut = sum(len(c) for c in chunks[:half])
    v = np.concatenate(got)
    check(np.array_equal(v[:cut], old(X[:cut])),
          "verdicts before the swap differ from the old DAG's")
    check(np.array_equal(v[cut:], new(X[cut:])),
          "verdicts after the swap differ from the new DAG's")
    st = eng.stats()
    check(st["swaps"] == 1 and st["swap_pkt_offsets"] == [cut],
          f"expected one swap at packet {cut}: {st['swap_pkt_offsets']}")
    return {"swaps": st["swaps"], "swap_lat_ms": st["swap_lat_ms"],
            "swap_pkt_offsets": st["swap_pkt_offsets"],
            "backend_batches": st["backend_batches"]}


# ----------------------------------- multi-table and telemetry (slice 4)

MULTI_SUFFIXES = ("mlp", "mat", "centroid")
MULTI_BATCHES = (1, 37, 512)
TWO_TABLE_SCENARIOS = ("ddos_burst", "port_scan")
TEL_ROUNDS = 6                     # as benchmarks/telemetry_overhead.py
TEL_PASSES = 5                     # stream passes per round: ~80,000 packets
TEL_GATE = 0.97                    # the reference's budget


def two_table(suffix="mlp", mitigated=False, n_slots=S_KERNEL,
              hidden=(16, 8)):
    """The two-table configuration (``testing.two_table_stages``): the
    flow-ddos table (W = 28) and a per-destination-port aggregate (W =
    19) feeding one 47-wide classifier; with ``mitigated`` the mat-fused
    action table, Mitigate(2,048 slots, threshold 6)."""
    from repro_torch.core import stageir
    from repro_torch.data import traffic
    from repro_torch.flowstate import MitigationSpec
    from repro_torch.flowstate.registers import FlowStateSpec
    from repro_torch.testing import two_table_stages

    mit = (MitigationSpec(n_slots=MIT_SLOTS, threshold=MIT_THRESHOLD)
           if mitigated else None)
    return two_table_stages(stageir, traffic, FlowStateSpec,
                            n_slots=n_slots, port_slots=n_slots,
                            suffix=suffix, mitigation=mit, hidden=hidden)


def multi_lowered(stages, dev):
    """A two-table stage list -> (TablePlans, SuffixPlan, packed
    classifier, MitigationSpec | None), as the fused lowering packs
    them."""
    from repro_torch.core import cuda_backend, stageir

    rest, mit = stageir.split_mitigation(stages)
    groups, suffix = stageir.split_stateful_multi(rest)
    desc, reason = cuda_backend._plan_fused(groups, suffix, mit)
    check(reason is None, f"the two-table pipeline declines: {reason}")
    groups, modes, cls, mit_spec = desc
    sp, params = cuda_backend._pack_classifier(cls, dev)
    return cuda_backend._table_plans(groups, modes), sp, params, mit_spec


def multi_batch(dev, stages, pattern, B, seed, ragged, dup_bins=True):
    """Per-table operands of one batch: table 0 keyed by ``pattern`` of
    ``repro_torch.testing``, table 1 by "mixed" (a few keys, deep
    chains), the valid mask shared; bins as ``testing.flow_batch`` plants
    them with ``dup_bins``."""
    import torch

    from repro_torch.core import stageir
    from repro_torch.testing import flow_batch

    groups, _ = stageir.split_stateful_multi(
        stageir.split_mitigation(stages)[0])
    ops = []
    for t, (_, ru, _) in enumerate(groups):
        b = flow_batch(ru.spec, pattern if t == 0 else "mixed", B,
                       seed=seed + t, ragged=ragged,
                       key_slots=max(ru.spec.n_slots, 2 * S_KERNEL),
                       dup_bins=dup_bins)
        ops.append([torch.as_tensor(b[k], device=dev)
                    for k in ("pkt_keys", "upd", "bins")])
        if t == 0:
            valid = torch.as_tensor(b["valid"], device=dev)
    return ops, valid


def multi_scores(tables, valid, tps, sp, params):
    """The plain scores of the classifier on the batch's readout rows."""
    import torch

    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels.flow_update import flow_update_ref

    zs = []
    for (k, r, pk, u, b), tp in zip(tables, tps):
        _, _, f = flow_update_ref(k, r, pk, u, b, valid,
                                  n_counters=tp.n_counters,
                                  n_ewma=tp.n_ewma, alpha=tp.alpha)
        zs.append(ff.suffix_readout(f, tp))
    return ff.suffix_scores(torch.cat(zs, 1), params, sp)


def kernels_check_multi(dev):
    """K1's multi-table mode against its plain version on the card, on
    the two-table configuration (2,048 slots per table): every suffix,
    with and without the action table (2,048 slots: table 0's
    segmentation; 4,096: its own), at B = 1, 37 and 512, ragged where
    B > 8, on the collision patterns of ``repro_torch.testing``; then the
    full-width classifier [47, 128 x 10, 2], five tables, and per-table
    readout modes ("all", "hist", raw) under the MLP and the MAT.  Two
    chained batches per case, the second from the tables the first
    left.  The chunk-edge patterns key table 0 in every suffix, with and
    without the action table, and in five tables; some of them again with
    bins as RegisterUpdate makes them (no column hit twice, so no chunk
    leaves the fast walk).  Tables and action
    tables bit-exact, also against the decomposition K1 walks by
    (``flow_update_staged_ref`` per table); MAT and mitigated verdicts
    exact; MLP and centroid verdicts under the margin rule.  -> max abs
    error."""
    import numpy as np
    import torch

    from repro_torch.core import stageir
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels.flow_update import flow_update_staged_ref
    from repro_torch.testing import he_mlp, mat_stages, verdict_mismatches

    cases = [(sfx, mit, B, pattern)
             for sfx in MULTI_SUFFIXES for mit in (None, MIT_SLOTS,
                                                   2 * MIT_SLOTS)
             for B, pattern in zip(MULTI_BATCHES, ("slot_runs", "same_slot",
                                                   "one_hot_flow"))]
    cases += [("mlp_full", None, 512, "mixed"), ("five", None, 512,
                                                  "slot_runs")]
    # per-table readout modes: a readout narrower than its table ("hist"),
    # a table read out raw (no WindowStats), at column offsets 0 and 24/28
    cases += [(f"modes {a}/{b} {sfx}", sm, 512, pattern)
              for (a, b), sfx, sm, pattern in (
                  (("all", "hist"), "mlp", None, "slot_runs"),
                  (("hist", "raw"), "mlp", MIT_SLOTS, "same_slot"),
                  (("raw", "hist"), "mat", None, "one_hot_flow"),
                  (("hist", "all"), "mat", 2 * MIT_SLOTS, "mixed"))]
    # the chunk-edge patterns (testing.EDGE_PATTERNS) on table 0
    cases += [("mlp", None, 512, "chain_edges"),
              ("mlp", 2 * MIT_SLOTS, 512, "one_chain"),
              ("mat", None, 512, "one_chain"),
              ("mat", MIT_SLOTS, 512, "chain_edges"),
              ("centroid", None, 512, "chain_edges"),
              ("centroid", 2 * MIT_SLOTS, 512, "one_chain"),
              ("five", None, 512, "one_chain"),
              ("five", MIT_SLOTS, 512, "chain_edges")]
    cases = ([c + (True,) for c in cases]
             + [("mlp", None, 512, "chain_edges", False),
                ("mat", MIT_SLOTS, 512, "one_chain", False),
                ("centroid", 2 * MIT_SLOTS, 512, "chain_edges", False),
                ("five", None, 512, "one_chain", False)])
    err, dropped, margin_rows = 0.0, 0, 0
    for i, (sfx, sm, B, pattern, dup) in enumerate(cases):
        stages = two_table(sfx if sfx in MULTI_SUFFIXES else "mlp")
        if sfx == "five" or sfx.startswith("modes"):
            rest, _ = stageir.split_mitigation(stages)
            groups, _ = stageir.split_stateful_multi(rest)
            if sfx == "five":
                groups = (groups * 3)[:5]
            else:
                modes = sfx.split()[1].split("/")
                groups = [(fk, ru) if mode == "raw" else
                          (fk, ru, stageir.WindowStats(ru.spec, mode))
                          for (fk, ru, _), mode in zip(groups, modes)]
            n_in = sum(g[2].n_out if len(g) == 3 else g[1].spec.width
                       for g in groups)
            cls = ([stageir.FusedMLP(*he_mlp((n_in, 16, 2), seed=4)),
                    stageir.Reduce("argmax")] if not sfx.endswith("mat")
                   else mat_stages(n_in))
            stages = [s for g in groups for s in g] + cls
        tps, sp, params, _ = multi_lowered(stages, dev)
        if sfx.startswith("modes"):
            check([tp.mode for tp in tps] == sfx.split()[1].split("/"),
                  f"{sfx}: lowered readout modes {[tp.mode for tp in tps]}")
        if sfx == "mlp_full":
            params = fm.pack_params(*he_mlp((params.widths[0],)
                                            + FULL_HIDDEN + (2,), seed=0),
                                    device=dev)
        mit = None
        if sm is not None:
            mit = (torch.full((sm,), -1, dtype=torch.int32, device=dev),
                   torch.zeros((sm, 2), device=dev),
                   ff.MitigationSpec(n_slots=sm, threshold=3,
                                     mode="drop" if i % 2 else "rate_limit",
                                     keep_every=3))
        state = [(torch.full((S_KERNEL,), -1, dtype=torch.int32,
                             device=dev),
                  torch.zeros((S_KERNEL, tp.width), device=dev))
                 for tp in tps]
        name = f"multi {sfx} mit={sm} B={B} {pattern} dup_bins={dup}"
        for step in range(2):
            ops, valid = multi_batch(dev, stages, pattern, B,
                                     seed=500 + 2 * i + step,
                                     ragged=step == 1 and B > 8,
                                     dup_bins=dup)
            tables = [(k, r, *o) for (k, r), o in zip(state, ops)]
            ref = ff.fused_flow_serve_multi_ref(tables, valid, tps, sp,
                                                params, mit)
            got = ff.fused_flow_serve_multi(
                [(k.clone(), r.clone(), *o) for (k, r), o in
                 zip(state, ops)], valid, tps, sp, params,
                None if mit is None else (mit[0].clone(), mit[1].clone(),
                                          mit[2]))
            torch.cuda.synchronize()
            for r, g in zip(ref[:-1], got[:-1]):
                bits = (lambda x: x.view(torch.int32)) \
                    if r.dtype == torch.float32 else (lambda x: x)
                check(torch.equal(bits(r), bits(g)),
                      f"K1 multi-table state differs on {name}")
                err = max(err, max_abs(r, g))
            for t, ((k, r, pk, u, b), tp) in enumerate(zip(tables, tps)):
                dk, dr, _ = flow_update_staged_ref(
                    k, r, pk, u, b, valid, n_counters=tp.n_counters,
                    n_ewma=tp.n_ewma, alpha=tp.alpha)
                check(torch.equal(dk, got[2 * t]) and torch.equal(
                    dr.view(torch.int32), got[2 * t + 1].view(torch.int32)),
                    f"K1 multi-table table {t} differs from the "
                    f"decomposition on {name}")
            live = valid.bool()
            if sp.kind == "mat" or mit is not None:
                check(torch.equal(ref[-1][live], got[-1][live]),
                      f"K1 multi-table verdicts differ on {name}")
            else:
                sc = multi_scores(tables, valid, tps, sp, params)
                lm = (params.lmap.cpu().numpy() if sp.kind == "centroid"
                      else None)
                bad, close = verdict_mismatches(
                    got[-1][live].cpu().numpy(), sc[live].cpu().numpy(),
                    use_min=sp.kind == "centroid", label_map=lm)
                check(bad == 0, f"K1 multi-table verdicts differ on {name}")
                margin_rows += close
            n = len(tps)
            state = [(ref[2 * t], ref[2 * t + 1]) for t in range(n)]
            if mit is not None:
                dropped += int((got[-1][live] == ff.MITIGATED).sum())
                mit = (ref[2 * n], ref[2 * n + 1], mit[2])
    check(dropped > 0, "no multi-table mitigation case dropped a packet")
    emit({"phase": "kernels_check_multi", "cases": len(cases),
          "edge_cases": [f"{c[0]} mit={c[1]} {c[3]}"
                         + ("" if c[4] else " distinct_bins") for c in cases
                         if c[3] in ("chain_edges", "one_chain")],
          "batches": list(MULTI_BATCHES), "n_slots": S_KERNEL,
          "readout_widths": [28, 19], "n_in": 47,
          "readout_modes": [c[0] for c in cases if c[0].startswith("modes")],
          "mit_slots": [MIT_SLOTS, 2 * MIT_SLOTS], "dropped": dropped,
          "margin_rows": margin_rows, "max_abs_err": err})
    return {"fused_flow_serve_multi": err}


def multi_timing(dev):
    """K1's multi-table mode on one two-table batch (the ddos_burst
    stream's packets 4096..4607 against the tables its first 4,096
    packets leave), each suffix and the mitigated MAT: the wrapper
    (CUDA events, 50 back-to-back launches updating one copy of the
    tables in place with the same batch), the kernel's device time
    (profiler), the plain version and the bound: each table's touched
    rows and keys read and written once and its live packet operands,
    the classifier's parameters, the verdicts, and the touched action
    rows.  The scratch z [B, 47] is left out: the function needs no
    readout rows in device memory, so z is this design's own cost."""
    import torch

    from repro_torch.core import cuda_backend, stageir
    from repro_torch.data import traffic
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels.flow_update.ops import prepare_operands

    pk = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                             seed=STREAM_SEED).packets
    lo = 4096
    out = {}
    for mode, sfx, mitigated in (("mlp", "mlp", False), ("mat", "mat", False),
                                 ("centroid", "centroid", False),
                                 ("mat+mitigation", "mat", True)):
        stages = two_table(sfx, mitigated)
        tps, sp, params, mspec = multi_lowered(stages, dev)
        rest, mit_stage = stageir.split_mitigation(stages)
        pipe_groups, suffix = stageir.split_stateful_multi(rest)
        # the tables the first 4,096 packets leave, served fused
        step = cuda_backend.lower_stateful_fused(pipe_groups, suffix, dev,
                                                 mit_stage)
        state = []
        for _, ru, _ in pipe_groups:
            state += [torch.full((ru.spec.n_slots,), -1, dtype=torch.int32,
                                 device=dev),
                      torch.zeros((ru.spec.n_slots, ru.spec.width),
                                  device=dev)]
        if mspec is not None:
            state += [torch.full((mspec.n_slots,), -1, dtype=torch.int32,
                                 device=dev),
                      torch.zeros((mspec.n_slots, 2), device=dev)]
        ones = torch.ones(B_KERNEL, dtype=torch.int32, device=dev)
        for s in range(0, lo, B_KERNEL):
            x = torch.as_tensor(pk[s:s + B_KERNEL], device=dev)
            state = list(step(*state, x, ones)[:-1])
        x = torch.as_tensor(pk[lo:lo + B_KERNEL], device=dev)
        tables, segs = [], []
        for t, (fk, ru, _) in enumerate(pipe_groups):
            upd, bins = ru.prepare(x)
            *o, seg = prepare_operands(state[2 * t], state[2 * t + 1],
                                       fk.apply_keys(x), upd, bins, ones)
            tables.append(tuple(o[:5]))
            segs.append(seg)
        n = len(tables)
        mit = mseg = None
        B = B_KERNEL
        live = B
        byts = ops_n = 0
        chains = []
        for (k, r, pkk, u, b), tp, seg in zip(tables, tps, segs):
            W, U, H = r.shape[1], u.shape[1], b.shape[1]
            n_seg = int((seg.seg_len > 0).sum())
            chains.append(int(seg.seg_len.max()))
            byts += 2 * n_seg * (W + 1) * 4 + live * (4 + U * 4 + H * 4 + 4) \
                + B * 4 + n_seg * 4 * 2
            ops_n += live * (W * (1 + H) + 3 * tp.n_ewma)
        n_in = sum(tp.n_out for tp in tps)
        byts += B * 4 + B * 4               # valid, verdicts (z: not needed)
        if sp.kind == "mlp":
            byts += 4 * (params.w_flat.numel() + params.b_flat.numel())
            ops_n += live * 2 * sum(a * c for a, c in zip(
                params.widths[:-1], params.widths[1:]))
        elif sp.kind == "mat":
            F, E = params.edges.shape
            byts += 4 * (params.edges.numel() + params.tables.numel()
                         + params.lmap.numel())
            ops_n += live * F * (E + params.num_classes)
        else:
            byts += 4 * (params.cent.numel() + params.fidx.numel()
                         + params.lmap.numel())
            ops_n += live * 3 * params.cent.numel()
        shape = {"B": B, "n_slots": S_KERNEL, "widths": [tp.width
                                                          for tp in tps],
                 "n_in": n_in, "max_chain": chains}
        if mspec is not None:
            mit = (state[2 * n], state[2 * n + 1], mspec)
            mseg = ff.mitigation_segments(tables[0][2], ones, segs[0],
                                          S_KERNEL, mspec.n_slots)
            n_mseg = int((mseg.seg_len > 0).sum())
            byts += 2 * n_mseg * 3 * 4
            ops_n += 6 * live
            shape.update(mit_slots=mspec.n_slots, mit_segments=n_mseg)
        copy = [(k.clone(), r.clone(), pkk, u, b)
                for k, r, pkk, u, b in tables]
        mcopy = None if mit is None else (mit[0].clone(), mit[1].clone(),
                                          mspec)

        def k1(_c=copy, _v=ones, _s=segs, _t=tps, _sp=sp, _p=params,
               _m=mcopy, _ms=mseg):
            return ff.fused_flow_serve_multi_launch(_c, _v, _s, _t, _sp, _p,
                                                    _m, _ms)

        def plain(_c=tables, _t=tps, _sp=sp, _p=params, _m=mit):
            return ff.fused_flow_serve_multi_ref(_c, ones, _t, _sp, _p, _m)

        instance = K1_INSTANCE.format(kind=ff.SUFFIX_KINDS.index(sp.kind),
                                      cap=ff.MAX_TABLES)
        out[mode] = dict(
            ms=time_ms(k1, TIMED_LAUNCHES),
            **kernel_fields(kernel_device_ms({instance: k1})[instance]),
            plain_ms=time_ms(plain, 3), bound=bound(byts, ops_n), **shape)
    emit({"phase": "kernels_time_multi", "modes": out})
    return out


def state_arrays(state):
    """Every table of a state (one table or several, the action table
    included) as host arrays, floats as their int32 bits."""
    import numpy as np

    kl = getattr(state, "keys_list", (state.keys,))
    rl = getattr(state, "regs_list", (state.regs,))
    out = []
    for k, r in zip(kl, rl):
        out += [k.cpu().numpy(), r.cpu().numpy().view(np.int32)]
    if getattr(state, "mit_spec", None) is not None:
        out += [state.mit_keys.cpu().numpy(),
                state.mit_regs.cpu().numpy().view(np.int32)]
    return out


def same_state(a, b) -> bool:
    import numpy as np

    x, y = state_arrays(a), state_arrays(b)
    return len(x) == len(y) and all(np.array_equal(p, q)
                                    for p, q in zip(x, y))


def serve_engine(stages, backend, fuse, max_batch, dev, **kw):
    """A depth-2 engine over ``StatefulPipeline(stages)`` on ``dev``."""
    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.serve.packet_engine import PacketServeEngine

    pipe = StatefulPipeline(stages, backend=backend, fuse=fuse,
                            device=dev.type)
    return PacketServeEngine(pipe, feature_dim=len(traffic.COLUMNS),
                             max_batch=max_batch, depth=2, device=dev.type,
                             **kw)


def sync_checked_serve(eng, packets, step: int):
    """Serve ``packets``, each window of up to ``depth`` dispatches under
    ``set_sync_debug_mode("error")`` (a host sync in the dispatch
    raises) and the fetches, which wait on the card, outside it."""
    import numpy as np
    import torch

    eng.submit(packets)
    out = []
    while eng.pending:
        torch.cuda.set_sync_debug_mode("error")
        try:
            while eng.pending and eng.in_flight < eng.depth:
                eng._dispatch_batch(eng._take(min(step, eng.pending)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        while eng.in_flight:
            out.append(eng._fetch_one())
    out.append(eng.flush())
    return np.concatenate(out)


def path_two_table_phase(dev, repeats: int = 3):
    """The two-table configuration through ``PacketServeEngine(depth=2)``:
    ddos_burst and port_scan at 16,000 packets (seed 1), the MLP suffix
    and the mitigated MAT, B = 256 and 512 (the median of ``repeats``
    engines), fused (one K1 multi-table launch per batch) and split (K2 per table + K3 or K4, the action
    table graphed), each held against ``backend="interpret"`` on CPU
    tensors: tables and action table bit-exact, MAT and mitigated
    verdicts exact, MLP verdicts under the margin rule.  Launches held
    to batches (K1 = fused batches, K2 = 2 x split batches).  One engine
    per configuration dispatches under ``set_sync_debug_mode("error")``.
    Then hot swaps mid-stream: flow-ddos (one table) -> two-table and
    two-table -> flow-ddos, the detection tables starting fresh, and
    once more mitigated, the action table carrying bit-identically."""
    import numpy as np
    import torch

    from repro_torch.data import traffic
    from repro_torch.kernels import _ext
    from repro_torch.testing import verdict_mismatches

    cpu = torch.device("cpu")
    base = "cuda" if dev.type == "cuda" else "cpu-ref"
    rows, launches = [], {k: 0 for k in _ext.LAUNCHES}
    n_fused, n_split = 0, {"mlp": 0, "mat": 0}
    for scenario in TWO_TABLE_SCENARIOS:
        stream = traffic.make_stream(scenario, n_packets=N_PACKETS,
                                     seed=STREAM_SEED)
        for sfx, mitigated in (("mlp", False), ("mat", True)):
            stages = two_table(sfx, mitigated)
            _ext.reset_launches()
            ieng = serve_engine(stages, "interpret", True, 512, cpu)
            iv = np.concatenate(list(ieng.serve_stream(stream.chunks(512))))
            check(sum(_ext.LAUNCHES.values()) == 0,
                  "the interpret backend launched a kernel")
            scores = None
            if sfx == "mlp":
                tps, sp, params, _ = multi_lowered(stages, cpu)
                scores = plain_stream_scores(stages, stream.packets, tps, sp,
                                             params)
            split_name = "mixed" if mitigated else base
            _ext.reset_launches()
            for max_batch in (256, 512):
                for fuse in (True, False):
                    runs = []
                    for _ in range(repeats):
                        eng = serve_engine(stages, "cuda", fuse, max_batch,
                                           dev)
                        v = np.concatenate(list(eng.serve_stream(
                            stream.chunks(max_batch))))
                        name = f"{scenario} {sfx} B={max_batch} fuse={fuse}"
                        want = f"{base}-fused-flow" if fuse else split_name
                        check(eng.backend == want, f"{name}: {eng.backend}")
                        check(same_state(eng.state, ieng.state),
                              f"{name}: tables differ from interpret")
                        close = 0
                        if scores is None:
                            check(np.array_equal(v, iv),
                                  f"{name}: verdicts differ from interpret")
                        else:
                            bad, close = verdict_mismatches(v, scores)
                            check(bad == 0, f"{name}: {bad} verdicts differ")
                        st = eng.stats()
                        nb = st["batches"] + 1     # + the warm-up batch
                        if fuse:
                            n_fused += nb
                        else:
                            n_split[sfx] += nb
                        runs.append(st)
                    med = sorted(runs, key=lambda r: r["pkt_per_s"])[
                        len(runs) // 2]
                    rows.append({
                        "scenario": scenario, "suffix": sfx,
                        "action_table": mitigated, "max_batch": max_batch,
                        "depth": 2, **{k: med[k] for k in (
                            "backend", "pkt_per_s", "lat_p50_ms",
                            "lat_p99_ms", "dispatch_s", "wall_s",
                            "batches", "mitigated")},
                        "pkt_per_s_runs": sorted(r["pkt_per_s"]
                                                 for r in runs),
                        "margin_rows": close,
                        "interpret_pkt_per_s": ieng.stats()["pkt_per_s"]})
            got = dict(_ext.LAUNCHES)
            for k, c in got.items():
                launches[k] += c
            if mitigated:
                check(int((iv == -1).sum()) > 0,
                      f"{scenario}: nothing mitigated")
    torch.cuda.synchronize()
    want = {k: 0 for k in launches}
    want.update({"fused_flow_serve": n_fused,
                 "flow_update": 2 * sum(n_split.values()),
                 "fused_mlp_classify": n_split["mlp"],
                 "mat_lut_classify": n_split["mat"]})
    check(launches == want, f"path_two_table: launches {launches} != "
          f"{want} (fused {n_fused}, split {n_split})")
    # the dispatch makes no host sync, fused or split
    stream = traffic.make_stream("ddos_burst", n_packets=4096,
                                 seed=STREAM_SEED)
    sync = {}
    for sfx, mitigated in (("mlp", False), ("mat", True)):
        stages = two_table(sfx, mitigated)
        scores = None
        if sfx == "mlp":
            tps, sp, params, _ = multi_lowered(stages, cpu)
            scores = plain_stream_scores(stages, stream.packets, tps, sp,
                                         params)
        ref = None
        for fuse in (True, False):
            eng = serve_engine(stages, "cuda", fuse, 512, dev)
            v = sync_checked_serve(eng, stream.packets, 512)
            name = f"sync-checked {sfx} fuse={fuse}"
            if scores is not None:
                # K1 and K3 sum the MLP in different orders: hold each to
                # the plain scores under the margin rule
                bad, close = verdict_mismatches(v, scores)
                check(bad == 0, f"{name}: {bad} verdicts differ from the "
                      "plain scores")
                sync[f"{sfx} fuse={fuse} margin_rows"] = close
            if ref is None:
                ref = (v, eng.state)
            else:
                diff = int((v != ref[0]).sum())
                sync[f"{sfx} fused/split differing rows"] = diff
                check(scores is not None or diff == 0,
                      f"{name}: fused and split verdicts differ")
            check(same_state(eng.state, ref[1]),
                  f"{name}: fused and split tables differ")
    swaps = two_table_swaps(dev)
    emit({"phase": "path_two_table", "n_packets": N_PACKETS,
          "n_slots": S_KERNEL, "n_in": 47, "rows": rows,
          "launches": launches, "batches": {"fused": n_fused,
                                            "split": n_split},
          "sync_debug": "error, no raise", "sync_checked": sync,
          "swaps": swaps, "nvidia_smi": nvidia_smi()})
    return launches, swaps


def plain_stream_scores(stages, packets, tps, sp, params):
    """The plain classifier scores of a whole stream on CPU tensors: each
    table walked in arrival order (the sequential reference does not
    depend on batching) -> [N, classes] numpy."""
    import torch

    from repro_torch.core import stageir
    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels.flow_update import flow_update_ref

    groups, _ = stageir.split_stateful_multi(
        stageir.split_mitigation(stages)[0])
    x = torch.as_tensor(packets)
    valid = torch.ones(len(x), dtype=torch.int32)
    zs = []
    for (fk, ru, _), tp in zip(groups, tps):
        spec = ru.spec
        upd, bins = ru.prepare(x)
        _, _, f = flow_update_ref(
            torch.full((spec.n_slots,), -1, dtype=torch.int32),
            torch.zeros((spec.n_slots, spec.width)), fk.apply_keys(x), upd,
            bins, valid, n_counters=tp.n_counters, n_ewma=tp.n_ewma,
            alpha=tp.alpha)
        zs.append(ff.suffix_readout(f, tp))
    return ff.suffix_scores(torch.cat(zs, 1), params, sp).numpy()


def two_table_swaps(dev):
    """Hot swaps between the one-table flow-ddos pipeline and the
    two-table one, mid-stream (ddos_burst, 16,000 packets, B = 512,
    fused), each against the same swap on ``backend="interpret"`` (CPU
    tensors): verdicts and final state bit-exact, exactly one swap, the
    detection tables empty at the install and the action table (the
    mitigated pair) the same bits right before and right after it.
    -> one row per swap, with the engine's journal kinds."""
    import numpy as np
    import torch

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.testing import verdict_mismatches

    cpu = torch.device("cpu")
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                 seed=STREAM_SEED)
    half = N_PACKETS // 2
    one, one_mit = flow_ddos_stages(S_KERNEL), mat_fused_stages(S_KERNEL,
                                                                True)
    pairs = (("one->two", one, two_table("mlp")),
             ("two->one", two_table("mlp"), one),
             ("one->two mitigated", one_mit, two_table("mat", True)))
    out = []
    for name, old, new in pairs:
        runs = {}
        for backend, d in (("cuda", dev), ("interpret", cpu)):
            eng = serve_engine(old, backend, True, 512, d)
            eng.submit(stream.packets[:half])
            v1 = eng.flush()
            before = state_arrays(eng.state)
            eng.swap(StatefulPipeline(new, backend=backend, device=d.type))
            eng.flush()                  # the drained ring installs it
            after = state_arrays(eng.state)
            check(eng.stats()["swaps"] == 1, f"{name}: expected one swap")
            check(all((k < 0).all() for k in after[0:len(after) - (
                2 if "mitigated" in name else 0):2]),
                f"{name}: the detection tables did not start fresh")
            if "mitigated" in name:
                check(np.array_equal(before[-2], after[-2])
                      and np.array_equal(before[-1], after[-1]),
                      f"{name}: the action table did not carry")
                check(int((before[-2] >= 0).sum()) > 0,
                      f"{name}: the action table was empty at the swap")
            eng.submit(stream.packets[half:])
            v = np.concatenate([v1, eng.flush()])
            runs[backend] = (v, eng)
        (v, eng), (iv, ieng) = runs["cuda"], runs["interpret"]
        if "mitigated" in name:
            check(np.array_equal(v, iv), f"{name}: verdicts differ")
        else:
            # before the boundary the old pipeline's verdicts, after it a
            # fresh new pipeline's: the plain scores from empty tables
            for part, stages, lo, hi in ((0, old, 0, half),
                                         (1, new, half, N_PACKETS)):
                tps, sp, params, _ = multi_lowered(stages, cpu)
                sc = plain_stream_scores(stages, stream.packets[lo:hi], tps,
                                         sp, params)
                bad, _ = verdict_mismatches(v[lo:hi], sc)
                check(bad == 0, f"{name}: {bad} verdicts differ in part "
                      f"{part}")
        check(same_state(eng.state, ieng.state),
              f"{name}: final state differs from interpret")
        st = eng.stats()
        kinds = [e["kind"] for e in eng.telemetry().journal.events()]
        check(kinds.count("hot_swap") == 1,
              f"{name}: the journal holds {kinds.count('hot_swap')} swaps")
        out.append({"swap": name, "swaps": st["swaps"],
                    "swap_lat_ms": st["swap_lat_ms"],
                    "swap_pkt_offsets": st["swap_pkt_offsets"],
                    "backend_batches": st["backend_batches"],
                    "mitigated": st["mitigated"], "journal": kinds})
    return out


def hook_costs(eng, chunks, passes: int) -> dict:
    """Host time of every telemetry recording site of ``eng`` over
    ``passes`` ``serve_stream`` passes of ``chunks()`` -> {site: {"batch":
    us a batch on the dispatch/fetch path, "flush": us a batch spent at
    flush boundaries}}.  The sites are the engine's metric handles
    (counters, the backend label child, the two per-batch histograms),
    ``tracer.record`` by span ("dispatch", "batch"), the sampled
    segmentation (``apply_keys_np``, ``hash_slot_np``,
    ``batch_segmentation`` and the max-chain gauge), the health scan,
    and the whole ``_record_dispatch`` and (where the engine has it)
    ``_record_fetch`` methods, which contain the sites they call (timed
    nested, with the wrappers' own cost of about 0.2 us a call).  It
    wraps only handles and functions that every version of the engine
    has, so one checkout's smoke can time another's engine (``tools/compare_checkouts.py
    telemetry_hooks``)."""
    import collections
    import sys

    pe = sys.modules[type(eng).__module__]
    spent = collections.defaultdict(float)

    def timed(site, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[site] += time.perf_counter() - t
        return run

    class Handle:
        """A metric child whose recording calls are timed as ``site``."""

        def __init__(self, child, site):
            for name in ("inc", "observe", "set"):
                if hasattr(child, name):
                    setattr(self, name, timed(site, getattr(child, name)))

    tm = eng._tm
    for k in ("packets", "batches", "pad", "lockstep", "drain",
              "deep_pkts", "swaps"):
        tm[k] = Handle(tm[k], "counters")
    tm["mitigated"] = Handle(tm["mitigated"], "counter_mitigated")
    tm["max_chain"] = Handle(tm["max_chain"], "segmentation")
    tm["dispatch_ms"] = Handle(tm["dispatch_ms"], "histogram_dispatch")
    tm["batch_lat_ms"] = Handle(tm["batch_lat_ms"], "histogram_batch")
    eng._backend_children[eng.backend] = Handle(
        eng._backend_counter.labels(backend=eng.backend), "label_child")
    tracer = eng.telemetry().tracer
    rec = {"dispatch": timed("tracer_dispatch", tracer.record),
           "batch": timed("tracer_batch", tracer.record)}
    tracer.record = lambda name, *a, **kw: rec.get(
        name, rec["batch"])(name, *a, **kw)
    fk = eng._tel_flowkey
    fk.apply_keys_np = timed("segmentation", fk.apply_keys_np)
    patched = [(pe, "hash_slot_np"), (pe.T, "batch_segmentation")]
    saved = [getattr(m, n) for m, n in patched]
    for m, n in patched:
        setattr(m, n, timed("segmentation", getattr(m, n)))
    eng._scan_flow_health = timed("health_scan", eng._scan_flow_health)
    eng._record_dispatch = timed("record_dispatch", eng._record_dispatch)
    if hasattr(eng, "_record_fetch"):
        eng._record_fetch = timed("record_fetch", eng._record_fetch)
    b0 = eng.stats_.batches
    try:
        for _ in range(passes):
            for _ in eng.serve_stream(chunks()):
                pass
    finally:
        for (m, n), f in zip(patched, saved):
            setattr(m, n, f)
        del fk.apply_keys_np
    n = max(eng.stats_.batches - b0, 1)
    out = {}
    for site, sec in sorted(spent.items()):
        # the health scan runs at flush boundaries by design
        w = "flush" if site == "health_scan" else "batch"
        out[site] = {"batch": 0.0, "flush": 0.0, w: sec / n * 1e6}
    return {"batches": n, "us_per_batch": out}


def telemetry_phase(dev, mitigated_counts):
    """The flow-ddos fused path at B = 512 through two engines, telemetry
    off and on (the default), rounds interleaved off, on, off, on (as
    ``benchmarks/telemetry_overhead.py``), each round ``TEL_PASSES``
    passes of the stream: verdicts bit-identical, the packet counter
    equal to the packets served, the best adjacent-pair on/off pkt/s
    ratio at least the reference's 0.97; the median pair and their
    spread beside it.  Each round also reports, per batch, the engine's
    host ``dispatch_s`` and the pass's whole host time (serve_stream to
    its closing flush, the hooks included) for each engine.  The on
    engine's hooks (``_record_dispatch``, ``_record_fetch`` and the
    flush-time health scan) are also timed directly (host clock), as a share of its serving span; then a
    third engine serves ``TEL_PASSES`` passes with every recording site
    timed (``hook_costs``).  ``mitigated_counts`` are (counter,
    MITIGATED verdicts) of the path_mitigate_fused engines."""
    import numpy as np

    from repro_torch.data import traffic

    stages = flow_ddos_stages(S_KERNEL)
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                 seed=STREAM_SEED)
    engines = {mode: serve_engine(stages, "cuda", True, 512, dev,
                                  telemetry=tel)
               for mode, tel in (("off", False), ("on", None))}
    on = engines["on"]
    hook_s = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                hook_s[0] += time.perf_counter() - t
        return run

    for name in ("_record_dispatch", "_record_fetch", "_scan_flow_health"):
        if hasattr(on, name):
            setattr(on, name, timed(getattr(on, name)))
    for eng in engines.values():                 # one warm pass each
        for _ in eng.serve_stream(stream.chunks(512)):
            pass
    rates = {"off": [], "on": []}
    dispatch_us = {"off": [], "on": []}
    host_us = {"off": [], "on": []}
    hook_share = []
    verdicts = {}
    for _ in range(TEL_ROUNDS):
        for mode in ("off", "on"):
            eng = engines[mode]
            st = eng.stats_
            p0, w0, h0 = st.packets, st.wall_s, hook_s[0]
            b0, d0 = st.batches, st.dispatch_s
            t0 = time.perf_counter()
            for _ in range(TEL_PASSES):
                verdicts[mode] = np.concatenate(list(eng.serve_stream(
                    stream.chunks(512))))
            host = time.perf_counter() - t0
            wall = max(st.wall_s - w0, 1e-9)
            rates[mode].append((st.packets - p0) / wall)
            nb = max(st.batches - b0, 1)
            dispatch_us[mode].append((st.dispatch_s - d0) / nb * 1e6)
            host_us[mode].append(host / nb * 1e6)
            if mode == "on":
                hook_share.append((hook_s[0] - h0) / wall)
    check(np.array_equal(verdicts["on"], verdicts["off"]),
          "telemetry changed the served verdicts")
    snap = on.telemetry().snapshot()
    counted = snap["serve_packets_total"]["values"][0]["value"]
    check(counted == on.stats_.packets,
          f"packet counter {counted} != packets served {on.stats_.packets}")
    for c, n in mitigated_counts:
        check(c == n and n > 0, f"mitigated counter {c} != {n} MITIGATED "
              "verdicts on path_mitigate_fused")
    pairs = [a / b for a, b in zip(rates["on"], rates["off"])]
    ratio = max(pairs)
    sites = hook_costs(serve_engine(stages, "cuda", True, 512, dev),
                       lambda: stream.chunks(512), TEL_PASSES)
    emit({"phase": "telemetry", "max_batch": 512, "rounds": TEL_ROUNDS,
          "passes_per_round": TEL_PASSES,
          "packets_per_round": TEL_PASSES * N_PACKETS,
          "backend": on.backend, "pkt_per_s_off": rates["off"],
          "pkt_per_s_on": rates["on"], "pair_ratios": pairs,
          "overhead_ratio": ratio, "median_pair_ratio": float(
              np.median(pairs)), "pair_spread": max(pairs) - min(pairs),
          "dispatch_us_per_batch": dispatch_us,
          "host_us_per_batch": host_us,
          "hook_share_of_span": hook_share,
          "hook_ms_per_batch": 1e3 * hook_s[0] / on.stats_.batches,
          "hook_sites": sites,
          "gate": TEL_GATE, "mitigated_counts": mitigated_counts,
          "metrics": sorted(snap), "spans": len(on.telemetry().tracer),
          "nvidia_smi": nvidia_smi()})
    check(ratio >= TEL_GATE, f"telemetry on/off ratio {ratio:.4f} < "
          f"{TEL_GATE}")
    return ratio


# ------------------------------------------------- slice 5: LM serving

# bf16 dense tensor-core peak (NVIDIA data sheet): the operations bound of
# K7's bf16 calls (its f32 calls: the f32 rate)
BF16_FLOP_PER_S = 989e12
LM_ARCH, LM_SEED, LM_SLOTS, LM_MAX_SEQ, LM_NEW = "qwen3-1.7b", 0, 4, 1024, 32
# K7 against its plain version: f32 within 1e-5 (the same f32 math, the
# sums in another order; outputs of order 1); bf16 within 8e-3 of the
# output's scale, max(1, |plain|) (both compute in f32 from the same
# bf16 inputs and round once; two f32 results that straddle a rounding
# boundary land one bf16 step, 2^-7 of the value, apart)
K7_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# the LM path against backend="interpret" (plain attention), bf16 through
# 28 layers: a rounding flip of one layer's attention output (2^-8 of
# the value) moves the residual stream and so the logits, which are of
# scale 1 here (tied 0.02-std table after a unit-RMS final norm); greedy
# tokens may then first differ only where the top two logits lie within
# twice that of each other
LM_LOGIT_TOL = 0.1
LM_AGREE = 0.9                     # tests/test_train_serve.py's bound


def live_pairs(Sq: int, skv: int, causal: bool, window: int,
               q_offset: int) -> int:
    """(q, kv) pairs K7's masks keep: the work this call's data needs."""
    import numpy as np

    q_pos = q_offset + np.arange(Sq)
    hi = np.minimum(q_pos, skv - 1) if causal else np.full(Sq, skv - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k7_bound(B, Sq, H, K, D, itemsize, pairs, kv_rows):
    """Q and O once, the K and V rows the masks keep once, over the HBM
    rate; 4 * D operations per live pair per head over the bf16
    tensor-core rate (itemsize 2) or the f32 rate (itemsize 4)."""
    moved = itemsize * (2 * B * Sq * H * D + 2 * B * kv_rows * K * D)
    t_b = moved / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    t_o = 4.0 * B * H * D * pairs / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k7_kernels(dtype: str, Sq: int, D: int) -> list:
    """The kernels one K7 call launches, as the profiler names them: with
    Sq <= DECODE_MAX_SQ the split-KV decode and its combine in the call's
    dtype, longer bf16 the tensor-core prefill, longer f32 the f32
    prefill."""
    from repro_torch.kernels.flash_attention import DECODE_MAX_SQ

    if Sq <= DECODE_MAX_SQ:
        t = "float" if dtype == "float32" else "__nv_bfloat16"
        return [f"fa_decode_kernel<{t}, {D}>",
                f"fa_combine_kernel<{t}, {D}>"]
    if dtype == "float32":
        return [f"fa_prefill_f32_kernel<{D}>"]
    return [f"fa_prefill_kernel<{D}>"]


def k7_split_ref(dev, q, k, v, skv, **kw):
    """The plain decomposition (``attention_split_ref``) of the kernel a
    call takes: the wrapper's decode plan in 32-key tiles (either dtype),
    the bf16 prefill's 64-key tiles with P split into bf16 hi and lo, or
    the f32 prefill's 64-key tiles with P in f32."""
    import torch

    from repro_torch.kernels.flash_attention import (
        DECODE_MAX_SQ,
        attention_split_ref,
        decode_plan,
    )

    B, Sq, H, _ = q.shape
    k, v = k[:, :skv], v[:, :skv]
    if Sq > DECODE_MAX_SQ:
        return attention_split_ref(q, k, v, tile=64,
                                   split_p=q.dtype == torch.bfloat16, **kw)
    lo, hi, chunk, _ = decode_plan(
        B, Sq, H, k.shape[2], skv, n_sm=torch.cuda.get_device_properties(
            dev).multi_processor_count, **kw)
    return attention_split_ref(q, k, v, lo=lo, hi=hi, chunk=chunk, tile=32,
                               **kw)


def k7_inputs(dev, B, Sq, Skv, H, K, D, dtype, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))


# name, B, Sq, Skv, H, K, D, dtype, causal, window, q_offset, skv (None:
# Skv): the Qwen3-1.7B prefill and decode shapes, ragged rows with a
# window, starcoder2's G = 12, the smoke width D = 16, every D instance
# and f32, and the Jamba-1.5-Large shapes of path_hybrid_serve (64 query
# heads over 8 KV heads: prefills at S = 512 and 192, decode at the last
# index of each round), in bf16 and, for its f32 run, in f32
K7_CASES = (
    ("prefill_512", 4, 512, 512, 16, 8, 128, "bfloat16", True, 0, 0, None),
    ("prefill_2048", 4, 2048, 2048, 16, 8, 128, "bfloat16", True, 0, 0,
     None),
    ("decode_0", 4, 1, 1024, 16, 8, 128, "bfloat16", True, 0, 0, None),
    ("decode_511", 4, 1, 1024, 16, 8, 128, "bfloat16", True, 0, 511, None),
    ("decode_1023", 4, 1, 1024, 16, 8, 128, "bfloat16", True, 0, 1023,
     None),
    ("ragged_w256", 2, 1000, 1000, 16, 8, 128, "bfloat16", True, 256, 0,
     None),
    ("ragged_w4096", 2, 1000, 1000, 16, 8, 128, "bfloat16", True, 4096, 0,
     None),
    ("gqa_12", 2, 512, 512, 48, 4, 128, "bfloat16", True, 0, 0, None),
    ("d16_bf16", 2, 100, 130, 4, 2, 16, "bfloat16", True, 8, 5, 120),
    ("d16_f32", 2, 100, 130, 4, 2, 16, "float32", True, 8, 5, 120),
    ("d32_f32", 2, 65, 97, 8, 2, 32, "float32", False, 8, 5, None),
    ("d64_f32", 2, 200, 300, 4, 4, 64, "float32", True, 0, 100, None),
    ("prefill_512_f32", 2, 512, 512, 16, 8, 128, "float32", True, 0, 0,
     None),
    ("jamba_prefill_512", 4, 512, 512, 64, 8, 128, "bfloat16", True, 0, 0,
     None),
    ("jamba_prefill_192", 4, 192, 192, 64, 8, 128, "bfloat16", True, 0, 0,
     None),
    ("jamba_decode_255", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 255,
     None),
    ("jamba_decode_543", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 543,
     None),
    # the split-KV decode's edges at G = 8 (32-key chunks): the first key,
    # the last key of a chunk, the first of the next, the cache's last; a
    # window; Sq on both sides of DECODE_MAX_SQ; bf16 at D = 32 and 64
    ("decode_g8_0", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 0, None),
    ("decode_g8_63", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 63,
     None),
    ("decode_g8_64", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 64,
     None),
    ("decode_g8_1023", 4, 1, 1024, 64, 8, 128, "bfloat16", True, 0, 1023,
     None),
    ("decode_w100", 4, 1, 1024, 16, 8, 128, "bfloat16", True, 100, 700,
     None),
    ("sq4_decode", 2, 4, 300, 48, 4, 128, "bfloat16", True, 0, 200, None),
    ("sq5_prefill", 2, 5, 300, 48, 4, 128, "bfloat16", True, 0, 200, None),
    ("d32_bf16", 2, 65, 97, 8, 2, 32, "bfloat16", False, 8, 5, None),
    ("d32_decode_bf16", 2, 2, 97, 8, 2, 32, "bfloat16", False, 0, 5, None),
    ("d64_bf16", 2, 200, 300, 4, 4, 64, "bfloat16", True, 0, 100, None),
    # f32 through the split-KV decode and the f32 prefill: the Jamba
    # shapes of path_hybrid_serve's f32 run, the Qwen3 decode at the
    # cache's last key, a chunk edge at G = 8, a windowed decode at D =
    # 16, Sq on both sides of DECODE_MAX_SQ, D = 32 and 64 decodes
    ("jamba_prefill_512_f32", 4, 512, 512, 64, 8, 128, "float32", True, 0,
     0, None),
    ("jamba_prefill_192_f32", 4, 192, 192, 64, 8, 128, "float32", True, 0,
     0, None),
    ("jamba_decode_543_f32", 4, 1, 1024, 64, 8, 128, "float32", True, 0,
     543, None),
    ("decode_1023_f32", 4, 1, 1024, 16, 8, 128, "float32", True, 0, 1023,
     None),
    ("decode_511_f32", 4, 1, 1024, 16, 8, 128, "float32", True, 0, 511,
     None),
    ("decode_g8_63_f32", 4, 1, 1024, 64, 8, 128, "float32", True, 0, 63,
     None),
    ("d16_decode_f32", 2, 2, 130, 4, 2, 16, "float32", True, 8, 5, 120),
    ("sq4_decode_f32", 2, 4, 300, 48, 4, 128, "float32", True, 0, 200,
     None),
    ("sq5_prefill_f32", 2, 5, 300, 48, 4, 128, "float32", True, 0, 200,
     None),
    ("d32_decode_f32", 2, 2, 97, 8, 2, 32, "float32", False, 0, 5, None),
    ("d64_decode_f32", 2, 1, 300, 4, 4, 64, "float32", True, 40, 250,
     None),
    ("ragged_w256_f32", 2, 1000, 1000, 16, 8, 128, "float32", True, 256, 0,
     None),
    # slice 15's call forms, each in bf16 and f32 (``K7_FORMS``)
    *((c[0] + ("_f32" if dt == "float32" else ""),) + c[1:7] + (dt,)
      + c[7:] for c in (
        # Mixtral: a windowed prefill where the window binds (S > W), the
        # ring decode over a full ring and a partly written one
        ("mixtral_prefill_w4096", 1, 4352, 4352, 32, 8, 128, True, 4096, 0,
         None),
        ("mixtral_ring_decode", 2, 1, 4096, 32, 8, 128, False, 0, 0, None),
        ("mixtral_ring_decode_1000", 2, 1, 4096, 32, 8, 128, False, 0, 0,
         1000),
        # Llama-3.2-Vision's cross-attention over 6,404 image tokens
        # (ragged against the 32- and 64-key tiles)
        ("vlm_cross_prefill", 1, 512, 6404, 32, 8, 128, False, 0, 0, None),
        ("vlm_cross_decode", 4, 1, 6404, 32, 8, 128, False, 0, 0, None),
        # SeamlessM4T: the encoder's self-attention, the cross-attention
        ("seamless_encoder", 2, 512, 512, 16, 16, 64, False, 0, 0, None),
        ("seamless_cross_prefill", 4, 32, 512, 16, 16, 64, False, 0, 0,
         None),
        ("seamless_cross_decode", 4, 1, 512, 16, 16, 64, False, 0, 0,
         None))
      for dt in ("bfloat16", "float32")),
)


def kernels_check_lm(dev):
    """K7 against its plain version (``attention_ref`` over the first skv
    keys) and against the plain decomposition of the kernel the call takes
    (``k7_split_ref``) on the card at every case of ``K7_CASES``, each
    within ``K7_TOL``.  -> {"flash_attention": max abs error over the
    cases}."""
    import torch

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        flash_attention_launch,
    )

    rows, worst = [], 0.0
    for i, (name, B, Sq, Skv, H, K, D, dt, causal, window, q_offset,
            skv) in enumerate(K7_CASES):
        skv = Skv if skv is None else skv
        q, k, v = k7_inputs(dev, B, Sq, Skv, H, K, D, getattr(torch, dt), i)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = flash_attention_launch(q, k, v, skv=skv, **kw)
        want = attention_ref(q, k[:, :skv], v[:, :skv], **kw)
        torch.cuda.synchronize()
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"K7 {name}: output {got.dtype} {tuple(got.shape)}")
        diff = (got.float() - want.float()).abs()
        scale = want.float().abs().clamp_min(1.0) if dt == "bfloat16" \
            else torch.ones_like(diff)
        err = float(diff.max())
        check(bool((diff <= K7_TOL[dt] * scale).all()),
              f"K7 {name}: max abs {err} beyond {K7_TOL[dt]}")
        split = k7_split_ref(dev, q, k, v, skv, **kw).float()
        d_split = (got.float() - split).abs()
        scale = split.abs().clamp_min(1.0) if dt == "bfloat16" \
            else torch.ones_like(d_split)
        err_split = float(d_split.max())
        check(bool((d_split <= K7_TOL[dt] * scale).all()),
              f"K7 {name}: max abs {err_split} from its decomposition")
        worst = max(worst, err)
        rows.append({"case": name, "dtype": dt, "shape": [B, Sq, Skv, H, K,
                                                          D],
                     "causal": causal, "window": window,
                     "q_offset": q_offset, "skv": skv, "max_abs_err": err,
                     "max_abs_err_split": err_split,
                     "kernels": k7_kernels(dt, Sq, D)})
    emit({"phase": "kernels_check_lm", "tol": K7_TOL, "cases": rows})
    return {"flash_attention": worst}


# the timed shapes, D = 128: name, B, Sq, Skv, H, K, q_offset, dtype.  The
# Qwen3-1.7B heads (16 over 8) at prefill S = 512 (the path's first batch)
# and 2,048 and decode against 1,024 keys at q_offset 511 (the path's cache
# index is 512-543) and 1,023; the Jamba-1.5-Large heads (64 over 8) at
# path_hybrid_serve's first prefill and last decode; the f32 kernels at
# the same Qwen3 and Jamba shapes
K7_TIMED = (("prefill_512", 4, 512, 512, 16, 8, 0, "bfloat16"),
            ("prefill_2048", 4, 2048, 2048, 16, 8, 0, "bfloat16"),
            ("decode_511", 4, 1, 1024, 16, 8, 511, "bfloat16"),
            ("decode_1023", 4, 1, 1024, 16, 8, 1023, "bfloat16"),
            ("jamba_prefill_512", 4, 512, 512, 64, 8, 0, "bfloat16"),
            ("jamba_decode_543", 4, 1, 1024, 64, 8, 543, "bfloat16"),
            ("prefill_512_f32", 4, 512, 512, 16, 8, 0, "float32"),
            ("decode_511_f32", 4, 1, 1024, 16, 8, 511, "float32"),
            ("decode_1023_f32", 4, 1, 1024, 16, 8, 1023, "float32"),
            ("jamba_prefill_512_f32", 4, 512, 512, 64, 8, 0, "float32"),
            ("jamba_decode_543_f32", 4, 1, 1024, 64, 8, 543, "float32"))
K7_TIMED_D = 128
# slice 15's call forms, timed as K7_TIMED is: name, B, Sq, Skv, H, K, D,
# dtype, causal, window, q_offset, skv (None: Skv)
K7_TIMED_FORMS = tuple(
    (c[0] + ("_f32" if dt == "float32" else ""),) + c[1:7] + (dt,) + c[7:]
    for c in (
        ("mixtral_prefill_w4096", 1, 4352, 4352, 32, 8, 128, True, 4096, 0,
         None),
        ("mixtral_ring_decode", 2, 1, 4096, 32, 8, 128, False, 0, 0, None),
        ("vlm_cross_prefill", 4, 512, 6404, 32, 8, 128, False, 0, 0, None),
        ("vlm_cross_decode", 4, 1, 6404, 32, 8, 128, False, 0, 0, None),
        ("seamless_encoder", 4, 512, 512, 16, 16, 64, False, 0, 0, None),
        ("seamless_cross_decode", 4, 1, 512, 16, 16, 64, False, 0, 0,
         None))
    for dt in ("bfloat16", "float32"))


def kernels_time_lm(dev):
    """K7 at the shapes of ``K7_TIMED`` and ``K7_TIMED_FORMS``: wrapper
    ms over 50 calls (CUDA events), device ms (profiler: the call's
    kernels, ``k7_kernels``, summed per call), the plain version's ms,
    ``scaled_dot_product_attention``'s ms on the same inputs (prefill:
    causal, GQA; causal decode: the first q_offset + 1 keys, unmasked;
    a non-causal call: the first skv keys, unmasked; a window: its band
    as a boolean mask: the same function) as ``library_ms`` (CUDA
    events) and ``library_kernel_ms`` (its kernels' device time,
    profiler), and the bound.  -> {config: numbers}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        flash_attention_launch,
    )
    from repro_torch.kernels.flash_attention.ref import live_keys

    out = {}
    forms = [(name, B, Sq, Skv, H, K, K7_TIMED_D, dt, True, 0, q_offset,
              None) for name, B, Sq, Skv, H, K, q_offset, dt in K7_TIMED]
    for (name, B, Sq, Skv, H, K, D, dt, causal, window, q_offset,
         skv) in forms + list(K7_TIMED_FORMS):
        skv = Skv if skv is None else skv
        q, k, v = k7_inputs(dev, B, Sq, Skv, H, K, D, getattr(torch, dt), 7)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        k7 = lambda: flash_attention_launch(q, k, v, skv=skv, **kw)  # noqa
        names = k7_kernels(dt, Sq, D)
        calls = {names[0]: k7, **{n: lambda: None for n in names[1:]}}
        # the profiler now and then drops a run's events: read it again
        for _ in range(3):
            seen = kernel_device_ms(calls)
            if all(seen[n]["events"] == 20 for n in names):
                break
        parts = {n: seen[n]["ms"] for n in names}
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if causal and Sq == 1:
            kt, vt = kt[:, :, :q_offset + 1], vt[:, :, :q_offset + 1]
        elif not causal:
            kt, vt = kt[:, :, :skv], vt[:, :, :skv]
        elif window:
            # the band K7's window keeps, as SDPA's boolean mask
            i = torch.arange(Sq, device=dev)[:, None] + q_offset
            j = torch.arange(Skv, device=dev)[None, :]
            mask = (j <= i) & (j > i - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask,
            is_causal=causal and Sq > 1 and mask is None, enable_gqa=True)
        got = k7()
        # the yardstick must compute K7's function (a mask aligned
        # elsewhere would differ by O(1)); it rounds P to bf16 for P V
        check(max_abs(got, lib().transpose(1, 2)) <= 0.1,
              f"K7 {name} and SDPA compute different functions")
        pairs = live_pairs(Sq, skv, causal, window, q_offset)
        lo, hi = live_keys(Sq, skv, causal=causal, window=window,
                           q_offset=q_offset)
        kv_rows = hi - lo
        out[name] = dict(
            ms=time_ms(k7, TIMED_LAUNCHES),
            kernel_ms=(sum(parts.values()) if None not in parts.values()
                       else None),
            kernel_parts_ms=parts,
            kernel_events={n: seen[n]["events"] for n in names},
            plain_ms=time_ms(lambda: attention_ref(q, k, v, **kw), 10),
            library_ms=time_ms(lib, TIMED_LAUNCHES),
            library_kernel_ms=next(
                (t for t in (call_device_ms(lib) for _ in range(3)) if t),
                None),
            bound=k7_bound(B, Sq, H, K, D, q.element_size(), pairs, kv_rows),
            shape=[B, Sq, Skv, H, K, D], q_offset=q_offset, dtype=dt,
            causal=causal, window=window, skv=skv, pairs=pairs,
            kernels=names)
        keys = [key for n in names for key in seen[n]["keys"]]
        if keys:
            out[name]["kernel_keys"] = keys
    emit({"phase": "kernels_time_lm", **out, "nvidia_smi": nvidia_smi()})
    return out


def lm_requests(vocab: int):
    """8 requests of 32 new tokens: a batch of four 512-token prompts and
    one of 384-512 tokens (left-padded to the longest), seeded."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(LM_SEED)
    lens = [512] * 4 + [384, 512] + [int(n) for n in rng.integers(385, 512,
                                                                  2)]
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=LM_NEW) for i, n in enumerate(lens)]


def lm_batches(reqs, slots: int = LM_SLOTS):
    """The engine's lockstep batches: (S, [slots, S + new] left-padded
    prompts followed by each request's tokens, the requests)."""
    import numpy as np

    out = []
    for i in range(0, len(reqs), slots):
        group = reqs[i:i + slots]
        S = max(len(r.prompt) for r in group)
        new = max(r.max_new_tokens for r in group)
        toks = np.zeros((slots, S + new), np.int32)
        for j, r in enumerate(group):
            toks[j, S - len(r.prompt):S] = r.prompt
            toks[j, S:S + len(r.out)] = r.out
        out.append((S, toks, group))
    return out


def serve_both(cfg, params, make_requests, max_steps: int, dev,
               experts=None, slots: int = LM_SLOTS,
               max_seq: int = LM_MAX_SEQ) -> dict:
    """The requests of ``make_requests(vocab)`` through ``ServeEngine`` on
    ``backend="cuda"`` and on ``"interpret"`` (a warm-up request first),
    the launch counts set to 0 just before each ``run`` and read just
    after.  -> {backend: stats (tok/s without the warm-up), launches,
    calls, requests, the engine's backend name, peak GB}."""
    import numpy as np
    import torch

    from repro_torch.kernels import _ext
    from repro_torch.serve.engine import Request, ServeEngine

    runs = {}
    for backend in ("cuda", "interpret"):
        eng = ServeEngine(cfg, params, batch_slots=slots, max_seq=max_seq,
                          backend=backend, device=dev, experts=experts)
        eng.submit(Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                           max_new_tokens=2))
        eng.run()                                   # warm-up
        before = dict(eng.timing, tokens=eng.tokens_out)
        reqs = make_requests(cfg.vocab_size)
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _ext.reset_launches()
        stats = eng.run(max_steps=max_steps)
        torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        calls = {k: v - before[k] for k, v in
                 dict(eng.timing, tokens=eng.tokens_out).items()}
        # the engine's token count and tok/s include the warm-up's
        stats["tok_per_s"] = calls["tokens"] / stats["wall_s"]
        runs[backend] = dict(
            stats=stats, launches=launches, calls=calls, reqs=reqs,
            backend=eng.backend,
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return runs


def path_lm_serve(dev):
    """``ServeEngine`` with Qwen3-1.7B at full width and depth (28
    layers, d_model 2,048, 16/8 heads of 128, d_ff 6,144, vocab 151,936),
    bf16 weights (1-D scales f32) from ``torch.Generator`` seed 0,
    batch_slots 4, max_seq 1,024: 8 requests of 32 new tokens
    (``lm_requests``), counts set to 0 just before the run and read just
    after: K7 must launch 28 x (prefill + decode calls) times and nothing
    else.  Then the same engine on ``backend="interpret"`` (plain
    attention, same weights): prefill logits of the first batch within
    ``LM_LOGIT_TOL``; each request's tokens the same, or first differing
    where the plain path's teacher-forced top two logits lie within
    2 x ``LM_LOGIT_TOL``; and the decode-through-cache tokens agreeing with
    a teacher-forced forward's argmax on at least ``LM_AGREE`` of the
    positions (the mean, as tests/test_train_serve.py takes it), each
    miss where that forward's top two lie within 2 x ``LM_LOGIT_TOL``.
    The phase line is printed before these checks.  -> launches per
    kernel."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import forward
    from repro_torch.serve.steps import init_cache

    cfg = configs.get_config(LM_ARCH)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(LM_SEED), device=dev,
                         dtype=torch.bfloat16)
    runs = serve_both(cfg, params, lm_requests, 2 * LM_NEW, dev)
    cuda, plain = runs["cuda"], runs["interpret"]
    n_calls = cuda["calls"]["prefill_calls"] + cuda["calls"]["decode_calls"]
    check(cuda["launches"]["flash_attention"] == cfg.num_layers * n_calls,
          f"K7 launched {cuda['launches']['flash_attention']} times, not "
          f"{cfg.num_layers} x {n_calls}")
    check(sum(cuda["launches"].values())
          == cuda["launches"]["flash_attention"],
          f"the LM path launched other kernels: {cuda['launches']}")
    check(sum(plain["launches"].values()) == 0,
          f"backend='interpret' launched kernels: {plain['launches']}")
    check(cuda["stats"]["requests"] == 8
          and cuda["calls"]["tokens"] == 8 * LM_NEW,
          f"stats {cuda['stats']}, {cuda['calls']['tokens']} new tokens")

    # prefill logits of the first batch on both attention engines
    S, toks, _ = lm_batches(cuda["reqs"])[0]
    prompt = torch.as_tensor(toks[:, :S], device=dev)
    logits = {}
    with torch.no_grad():
        for backend in ("cuda", "interpret"):
            cache = init_cache(cfg, LM_SLOTS, LM_MAX_SEQ, device=dev)
            logits[backend] = forward(
                params, cfg, tokens=prompt, mode="prefill", caches=cache,
                logits_slice_last=True, backend=backend)[0].float()
    logit_err = max_abs(logits["cuda"], logits["interpret"])

    # tokens against the plain path, and against teacher forcing
    first_diff, agree, tf_misses = [], [], []
    for (S, toks, group), (_, ptoks, pgroup) in zip(
            lm_batches(cuda["reqs"]), lm_batches(plain["reqs"])):
        x = torch.as_tensor(toks[:, :-1], device=dev)
        with torch.no_grad():
            tf = {b: forward(params, cfg, tokens=x, mode="train",
                             backend=b)[0][:, S - 1:].float()
                  for b in ("cuda", "interpret")}
        pred = tf["cuda"].argmax(-1)
        for j, (r, pr) in enumerate(zip(group, pgroup)):
            out = torch.as_tensor(r.out, device=dev)
            agree.append(float((pred[j] == out).float().mean()))
            row = tf["cuda"][j]
            for t in torch.nonzero(pred[j] != out).flatten().tolist():
                tf_misses.append(float(row[t, pred[j, t]] - row[t, out[t]]))
            diff = np.flatnonzero(np.asarray(r.out) != np.asarray(pr.out))
            if diff.size:
                t = int(diff[0])
                row = tf["interpret"][j, t]
                first_diff.append({"rid": r.rid, "step": t, "margin": float(
                    row[pr.out[t]] - row[r.out[t]])})
    tm = cuda["calls"]
    emit({"phase": "path_lm_serve", "arch": LM_ARCH,
          "params": cfg.param_count(), "batch_slots": LM_SLOTS,
          "max_seq": LM_MAX_SEQ, "prompt_lens": [len(r.prompt)
                                                 for r in cuda["reqs"]],
          "max_new_tokens": LM_NEW, "backend": cuda["backend"],
          "launches": cuda["launches"]["flash_attention"],
          "prefill_calls": tm["prefill_calls"],
          "decode_calls": tm["decode_calls"],
          "prefill_ms": 1e3 * tm["prefill_s"] / tm["prefill_calls"],
          "decode_ms_per_step": 1e3 * tm["decode_s"] / tm["decode_calls"],
          "tok_per_s": cuda["stats"]["tok_per_s"],
          "wall_s": cuda["stats"]["wall_s"],
          "peak_gb": cuda["peak_gb"],
          "interpret": {
              "prefill_ms": 1e3 * plain["calls"]["prefill_s"]
              / plain["calls"]["prefill_calls"],
              "decode_ms_per_step": 1e3 * plain["calls"]["decode_s"]
              / plain["calls"]["decode_calls"],
              "tok_per_s": plain["stats"]["tok_per_s"]},
          "prefill_logit_err": logit_err, "logit_tol": LM_LOGIT_TOL,
          "requests_differing": len(first_diff), "first_diffs": first_diff,
          "teacher_forcing_agree": float(np.mean(agree)),
          "teacher_forcing_agree_by_request": agree,
          "teacher_forcing_miss_margins": tf_misses,
          "nvidia_smi": nvidia_smi()})
    check(logit_err <= LM_LOGIT_TOL,
          f"prefill logits differ by {logit_err} > {LM_LOGIT_TOL}")
    for d in first_diff:
        check(abs(d["margin"]) <= 2 * LM_LOGIT_TOL,
              f"request {d['rid']}: tokens first differ at step "
              f"{d['step']} with a margin of {d['margin']}")
    check(all(m <= 2 * LM_LOGIT_TOL for m in tf_misses),
          f"decode misses teacher forcing outside the margin: {tf_misses}")
    check(np.mean(agree) >= LM_AGREE,
          f"decode against teacher forcing agrees on {np.mean(agree)}")
    return cuda["launches"]


# ---------------------------------------- slice 6: hybrid LM serving (K8)

# K8's template instances, as the profiler names them: the TPU kernel's
# interface (dA and dBx in) and the discretizing entry (x in bf16 or f32)
K8_INSTANCE = "selective_scan_kernel<{N}, false, false>"
K8_DISC_INSTANCE = "selective_scan_kernel<{N}, true, {xbf}>"
# K8 against its plain version: within 1e-5 x (1 + |plain|).  h is the
# same f32 products and sums in the same order (no FMA on either side),
# so it matches bit for bit; y sums its N products in another order.
# Against the kernel's own order written out (selective_scan_channel_ref)
# y matches bit for bit too
K8_TOL = 1e-5
# name, B, S, di, N, h0 (nonzero random or zero), dA ("uniform":
# exp(-U(0, 2)); "dt": exp(dt * A), dt = softplus(N(0, 1)), A = -(1..N))
K8_CASES = (
    ("prefill_512", 4, 512, 16384, 16, "random", "uniform"),
    ("prefill_256", 4, 256, 16384, 16, "random", "uniform"),
    ("prefill_192", 4, 192, 16384, 16, "random", "dt"),
    ("decode_1", 4, 1, 16384, 16, "random", "uniform"),
    ("prefill_512_dt", 4, 512, 16384, 16, "random", "dt"),
    ("decode_1_dt", 4, 1, 16384, 16, "random", "dt"),
    ("smoke_n8", 2, 64, 128, 8, "random", "dt"),
    ("odd_s3", 1, 3, 16384, 16, "zero", "uniform"),
    ("odd_s3_n8_di100", 1, 3, 100, 8, "random", "dt"),
)
# the timed shapes: the path's prefill (B = 4, S = 512) and decode step
K8_TIMED = (("prefill_512", 4, 512, 16384, 16), ("decode_1", 4, 1, 16384, 16))

# path_hybrid_serve: Jamba-1.5-Large at every published width, one
# 8-layer period (one of the deployment's 9 pipeline stages), experts
# 0-7 of 16 (expert parallelism ep = 2: this card's share)
HY_ARCH, HY_LAYERS, HY_EXPERTS = "jamba-1.5-large-398b", 8, range(0, 8)
# the f32 run's share: f32 weights take 4 bytes, so 2 experts of each MoE
# layer fit beside the rest of the period (45.7 GB)
HY_F32_EXPERTS = range(0, 2)
HY_SEED = 0
# round 1: four 512-token prompts, 32 new tokens; round 2: four prompts
# of 160-192 tokens (left-padded to 192), 64 new tokens.  Both prefills
# take the reference's length rules (Mamba: S % min(256, S) == 0; MoE:
# B * S <= 256 or a multiple of 256), and so does round 2's teacher-
# forced forward over 192 + 64 = 256 positions
HY_ROUNDS = ((512, 512, 32), (160, 192, 64))


def hybrid_config():
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config(HY_ARCH),
                               num_layers=HY_LAYERS)


def scan_inputs(dev, B, S, di, N, h0_kind, dA_kind, seed):
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if dA_kind == "dt":
        dt = F.softplus(randn(B, S, di, 1))
        dA = torch.exp(dt * -torch.arange(1, N + 1, device=dev,
                                          dtype=torch.float32))
    else:
        dA = torch.exp(-2.0 * torch.rand((B, S, di, N), generator=g,
                                         device=dev))
    h0 = randn(B, di, N) if h0_kind == "random" else torch.zeros(
        (B, di, N), device=dev)
    return dA.contiguous(), randn(B, S, di, N), randn(B, S, N), h0


def k8_bound(B, S, di, N):
    """The TPU interface: dA and dBx read once, C and h0 read once, y and
    h_final written once, over the HBM rate; 4 f32 operations per (t, d,
    n) (the step's multiply and add, the readout's product and sum) over
    67 TFLOP/s."""
    moved = 4 * (2 * B * S * di * N + B * S * N + 2 * B * di * N
                 + B * S * di)
    return bound(moved, 4.0 * B * S * di * N)


def k8_disc_bound(B, S, di, N, x_itemsize=4):
    """The discretizing entry: dt, x and y once, B and C once, A once, h0
    and h_final once, over the HBM rate; 8 f32 operations per (t, d, n)
    (dt A, its exp counted as one, dt B, times x, the step's multiply and
    add, the readout's product and sum) over 67 TFLOP/s."""
    moved = (4 * (2 * B * S * di + 2 * B * S * N + di * N + 2 * B * di * N)
             + x_itemsize * B * S * di)
    return bound(moved, 8.0 * B * S * di * N)


def disc_inputs(dev, B, S, di, N, x_dtype, seed):
    """The discretizing entry's operands from one generator: dt =
    softplus(N(0, 1)) [B, S, di], A = -exp(N(0, 1)) [di, N], Bm and Cm
    N(0, 1) [B, S, N], x N(0, 1) [B, S, di] in ``x_dtype``, h0 N(0, 1)
    [B, di, N]."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return (F.softplus(randn(B, S, di)), -torch.exp(randn(di, N)),
            randn(B, S, N), randn(B, S, N), randn(B, S, di).to(x_dtype),
            randn(B, di, N))


def kernels_check_scan(dev):
    """K8 on the card at every case of ``K8_CASES``, through both entries.
    The TPU kernel's interface on ``scan_inputs``: y and h_final within
    ``K8_TOL`` x (1 + |plain|) of ``selective_scan_ref``, y bit for bit
    ``selective_scan_channel_ref``.  The discretizing entry on
    ``disc_inputs`` (x in bf16 at even cases, f32 at odd): h_final bit
    for bit the eager discretization (``discretize``) followed by the
    TPU-interface K8, y bit for bit the channel decomposition of the same
    discretization and within ``K8_TOL`` x (1 + |plain|) of the plain
    version.  -> {"selective_scan": max abs error over the cases,
    "selective_scan_discretized": the same}."""
    import torch

    from repro_torch.kernels.selective_scan import (
        discretize,
        selective_scan_channel_ref,
        selective_scan_discretized_launch,
        selective_scan_launch,
        selective_scan_ref,
    )

    def close(got, want, what):
        diff = (got - want).abs()
        err = float(diff.max())
        check(bool((diff <= K8_TOL * (1 + want.abs())).all()),
              f"K8 {what} max abs {err} beyond {K8_TOL} x (1 + |plain|)")
        return err

    def bits(got, want, what):
        n = int((got != want).sum())
        check(n == 0, f"K8 {what}: {n} values differ from the kernel's "
              "order written out")

    rows, worst, worst_disc = [], 0.0, 0.0
    for i, (name, B, S, di, N, h0_kind, dA_kind) in enumerate(K8_CASES):
        args = scan_inputs(dev, B, S, di, N, h0_kind, dA_kind, 100 + i)
        y, h = selective_scan_launch(*args)
        want_y, want_h = selective_scan_ref(*args)
        chan_y, _ = selective_scan_channel_ref(*args)
        torch.cuda.synchronize()
        check(y.shape == (B, S, di) and h.shape == (B, di, N),
              f"K8 {name}: outputs {tuple(y.shape)}, {tuple(h.shape)}")
        errs = {"y": close(y, want_y, f"{name} y"),
                "h_final": close(h, want_h, f"{name} h_final")}
        bits(y, chan_y, f"{name} y")
        worst = max(worst, *errs.values())
        row = {"case": name, "shape": [B, S, di, N], "h0": h0_kind,
               "dA": dA_kind, "max_abs_err": errs,
               "max_abs_y": float(want_y.abs().max())}
        del args, y, h, want_y, want_h, chan_y

        x_dtype = torch.bfloat16 if i % 2 == 0 else torch.float32
        dt, A, Bm, Cm, x, h0 = disc_inputs(dev, B, S, di, N, x_dtype,
                                           200 + i)
        y, h = selective_scan_discretized_launch(dt, A, Bm, Cm, x, h0)
        dA, dBx = discretize(dt, A, Bm, x)
        _, tpu_h = selective_scan_launch(dA, dBx, Cm, h0)
        chan_y, _ = selective_scan_channel_ref(dA, dBx, Cm, h0)
        want_y, want_h = selective_scan_ref(dA, dBx, Cm, h0)
        torch.cuda.synchronize()
        check(y.shape == (B, S, di) and h.shape == (B, di, N),
              f"K8 {name} discretized: outputs {tuple(y.shape)}, "
              f"{tuple(h.shape)}")
        n_h = int((h != tpu_h).sum())
        check(n_h == 0, f"K8 {name} discretized: h_final differs from the "
              f"eager discretization and the TPU-interface K8 in {n_h} "
              "values")
        derr = {"y": close(y, want_y, f"{name} discretized y"),
                "h_final": close(h, want_h, f"{name} discretized h_final")}
        bits(y, chan_y, f"{name} discretized y")
        worst_disc = max(worst_disc, *derr.values())
        row["discretized"] = {"x_dtype": str(x_dtype).split(".")[1],
                              "max_abs_err": derr}
        rows.append(row)
        del dt, A, Bm, Cm, x, h0, y, h, dA, dBx, tpu_h, chan_y, want_y, want_h
        torch.cuda.empty_cache()
    emit({"phase": "kernels_check_scan", "tol": K8_TOL, "cases": rows})
    return {"selective_scan": worst, "selective_scan_discretized": worst_disc}


def kernels_time_scan(dev):
    """K8 at the hybrid path's shapes: prefill B = 4, S = 512 and one
    decode step S = 1, di = 16,384, N = 16.  The discretizing entry
    (x in bf16, as the path's bf16 run gives it, and in f32): wrapper ms
    over 50 calls (CUDA events), device ms (profiler), the plain
    version's ms and its bound; beside it the "before", the eager
    discretization's device ms (``discretize``: its four passes, one
    profiler run) plus the TPU-interface K8's, which the Mamba block ran
    until the discretizing entry took its place.  The TPU interface on
    its own inputs is timed the same way against its own bound.  No
    single PyTorch call computes the scan, so ``library_ms`` is null.  ->
    {"discretized": {config: numbers}, "tpu_interface": {config:
    numbers}}."""
    import torch

    from repro_torch.kernels.selective_scan import (
        discretize,
        selective_scan_discretized_launch,
        selective_scan_discretized_ref,
        selective_scan_launch,
        selective_scan_ref,
    )

    out = {"discretized": {}, "tpu_interface": {}}
    for name, B, S, di, N in K8_TIMED:
        args = scan_inputs(dev, B, S, di, N, "random", "dt", 7)
        k8 = lambda: selective_scan_launch(*args)  # noqa: E731
        seen = kernel_device_ms({K8_INSTANCE.format(N=N): k8})
        out["tpu_interface"][name] = dict(
            ms=time_ms(k8, TIMED_LAUNCHES), **kernel_fields(seen.popitem()[1]),
            plain_ms=time_ms(lambda: selective_scan_ref(*args), 5),
            library_ms=None, bound=k8_bound(B, S, di, N),
            shape=[B, S, di, N], kernel=K8_INSTANCE.format(N=N))
        del args, seen
        torch.cuda.empty_cache()
        for xdt in ("bfloat16", "float32"):
            dt, A, Bm, Cm, x, h0 = disc_inputs(dev, B, S, di, N,
                                               getattr(torch, xdt), 8)
            inst = K8_DISC_INSTANCE.format(
                N=N, xbf="true" if xdt == "bfloat16" else "false")
            disc = lambda: selective_scan_discretized_launch(  # noqa: E731
                dt, A, Bm, Cm, x, h0)
            dA, dBx = discretize(dt, A, Bm, x)
            seen = kernel_device_ms({
                inst: disc, K8_INSTANCE.format(N=N):
                lambda: selective_scan_launch(dA, dBx, Cm, h0)})
            before_k8 = seen[K8_INSTANCE.format(N=N)]["ms"]
            del dA, dBx
            torch.cuda.empty_cache()
            eager = next((t for t in (call_device_ms(
                lambda: discretize(dt, A, Bm, x), n=5) for _ in range(3))
                if t), None)
            row = dict(
                ms=time_ms(disc, TIMED_LAUNCHES), **kernel_fields(seen[inst]),
                plain_ms=time_ms(lambda: selective_scan_discretized_ref(
                    dt, A, Bm, Cm, x, h0), 3),
                library_ms=None,
                bound=k8_disc_bound(B, S, di, N, x.element_size()),
                before_eager_kernel_ms=eager,
                before_k8_kernel_ms=before_k8,
                before_kernel_ms=(eager + before_k8 if eager and before_k8
                                  else None),
                shape=[B, S, di, N], x_dtype=xdt, kernel=inst)
            out["discretized"][name if xdt == "bfloat16"
                               else f"{name}_x_f32"] = row
            del dt, A, Bm, Cm, x, h0
            torch.cuda.empty_cache()
    emit({"phase": "kernels_time_scan", **out, "nvidia_smi": nvidia_smi()})
    return out


def hybrid_requests(vocab: int, rounds=HY_ROUNDS, slots: int = LM_SLOTS):
    """Round 1 then round 2 of ``rounds`` (lowest and longest prompt
    length, new tokens), ``slots`` requests each, seeded: all but the
    last prompt of a round draw their lengths, the last takes the
    round's longest."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(HY_SEED + 1)
    reqs = []
    for lo, hi, new in rounds:
        lens = [int(n) for n in rng.integers(lo, hi + 1, slots - 1)]
        for n in lens + [hi]:
            reqs.append(Request(rid=len(reqs), prompt=rng.integers(
                0, vocab, n).astype(np.int32), max_new_tokens=new))
    return reqs


def replay_logits(params, cfg, toks, S, n, backend, experts, dev,
                  max_seq: int = LM_MAX_SEQ, memory=None):
    """The serving path's last-position logits along given tokens: a
    prefill of toks[:, :S] (over ``memory``, a vlm's or encdec's memory
    embeddings), then n - 1 decode steps fed toks[:, S + t] -> [n, B, V]
    f32 (step t's logits choose token S + t)."""
    import torch

    from repro_torch.models.transformer import forward
    from repro_torch.serve.steps import init_cache

    cache = init_cache(cfg, toks.shape[0], max_seq, device=dev)
    x = torch.as_tensor(toks, device=dev)
    kw = dict(caches=cache, logits_slice_last=True, backend=backend,
              experts=experts)
    out = []
    with torch.no_grad():
        out.append(forward(params, cfg, tokens=x[:, :S], mode="prefill",
                           memory_embeds=memory, **kw)[0][:, -1].float())
        for t in range(n - 1):
            out.append(forward(params, cfg, tokens=x[:, S + t:S + t + 1],
                               mode="decode", index=S + t,
                               **kw)[0][:, -1].float())
    return torch.stack(out)


def prefill_logits(params, cfg, toks, backend, experts, dev,
                   max_seq: int = LM_MAX_SEQ, memory=None):
    """-> (last-position logits [B, V] f32, MoE aux) of a prefill (over
    ``memory``)."""
    import torch

    from repro_torch.models.transformer import forward
    from repro_torch.serve.steps import init_cache

    x = torch.as_tensor(toks, device=dev)
    cache = init_cache(cfg, x.shape[0], max_seq, device=dev)
    with torch.no_grad():
        lg, _, aux = forward(params, cfg, tokens=x, mode="prefill",
                             caches=cache, logits_slice_last=True,
                             backend=backend, experts=experts,
                             memory_embeds=memory)
    return lg[:, -1].float(), aux


def first_diffs(params, cfg, reqs, preqs, experts, dev,
                slots: int = LM_SLOTS, max_seq: int = LM_MAX_SEQ,
                memories=None):
    """Each request whose served tokens differ from the plain path's: the
    first differing step and the plain path's own logit margin there
    between its token and the served one (its logits along its tokens,
    ``replay_logits``; batch i over ``memories[i]``)."""
    import numpy as np

    out = []
    for i, ((S, _, group), (_, ptoks, pgroup)) in enumerate(zip(
            lm_batches(reqs, slots), lm_batches(preqs, slots))):
        diffs = [np.flatnonzero(np.asarray(r.out) != np.asarray(pr.out))
                 for r, pr in zip(group, pgroup)]
        if not any(d.size for d in diffs):
            continue
        n = 1 + max(int(d[0]) for d in diffs if d.size)
        lg = replay_logits(params, cfg, ptoks, S, n, "interpret", experts,
                           dev, max_seq, memories and memories[i])
        for j, (r, pr, d) in enumerate(zip(group, pgroup, diffs)):
            if d.size:
                t = int(d[0])
                out.append({"rid": r.rid, "step": t, "margin": float(
                    lg[t, j, pr.out[t]] - lg[t, j, r.out[t]])})
    return out


def teacher_forcing(params, cfg, reqs, experts, dev,
                    backend: str = "cuda", slots: int = LM_SLOTS,
                    memory=None) -> dict:
    """One lockstep batch of served requests against a teacher-forced
    forward (on ``backend``, over ``memory``) over its prompts and new
    tokens: per request the share of new tokens equal to that forward's
    argmax, each miss with the forward's margin between its argmax and
    the served token, and the forward's MoE drop fraction (summed over
    the layers; 0 without MoE)."""
    import torch

    from repro_torch.models.transformer import forward

    (S, toks, group), = lm_batches(reqs, slots)
    with torch.no_grad():
        tf, _, aux = forward(params, cfg, tokens=torch.as_tensor(
            toks, device=dev), mode="train", backend=backend,
            experts=experts, memory_embeds=memory)
    tf = tf[:, S - 1:-1].float()
    pred = tf.argmax(-1)
    agree, misses = [], []
    for j, r in enumerate(group):
        out = torch.as_tensor(r.out, device=dev)
        agree.append(float((pred[j] == out).float().mean()))
        for t in torch.nonzero(pred[j] != out).flatten().tolist():
            misses.append({"rid": r.rid, "step": t, "margin": float(
                tf[j, t, pred[j, t]] - tf[j, t, out[t]])})
    return {"agree": agree, "misses": misses,
            "drop_frac_sum": float(aux.get("moe_drop_frac", 0.0))}


def hybrid_serve(cfg, params, experts, dev) -> dict:
    """Both rounds through ``serve_both``: K8's discretizing entry must
    launch once per Mamba mixer per call, K7 once per call, nothing else
    (the TPU-interface K8 not at all); the plain path
    nothing; every request gets its tokens, in the vocabulary."""
    from repro_torch.kernels import _ext

    n_mamba = cfg.attn_period - 1
    n_new = sum(new for _, _, new in HY_ROUNDS)
    runs = serve_both(cfg, params, hybrid_requests, n_new, dev, experts)
    cuda, plain = runs["cuda"], runs["interpret"]
    n_calls = cuda["calls"]["prefill_calls"] + cuda["calls"]["decode_calls"]
    want = dict.fromkeys(_ext.LAUNCHES, 0) | {
        "selective_scan_discretized": n_mamba * n_calls,
        "flash_attention": n_calls}
    check(cuda["launches"] == want,
          f"path_hybrid_serve launched {cuda['launches']}, not {want}")
    check(sum(plain["launches"].values()) == 0,
          f"backend='interpret' launched kernels: {plain['launches']}")
    for run in runs.values():
        check(run["stats"]["requests"] == 2 * LM_SLOTS
              and run["calls"]["tokens"] == LM_SLOTS * n_new
              and all(len(r.out) == r.max_new_tokens
                      and 0 <= min(r.out) <= max(r.out) < cfg.vocab_size
                      for r in run["reqs"]),
              f"stats {run['stats']}, {run['calls']['tokens']} tokens")
    return runs


def run_fields(runs) -> dict:
    cuda, plain = runs["cuda"], runs["interpret"]
    tm, pm = cuda["calls"], plain["calls"]
    return {"backend": cuda["backend"],
            "launches": {k: v for k, v in cuda["launches"].items() if v},
            "prefill_calls": tm["prefill_calls"],
            "decode_calls": tm["decode_calls"],
            "prefill_ms": 1e3 * tm["prefill_s"] / tm["prefill_calls"],
            "decode_ms_per_step": 1e3 * tm["decode_s"] / tm["decode_calls"],
            "tok_per_s": cuda["stats"]["tok_per_s"],
            "wall_s": cuda["stats"]["wall_s"], "peak_gb": cuda["peak_gb"],
            "interpret": {
                "prefill_ms": 1e3 * pm["prefill_s"] / pm["prefill_calls"],
                "decode_ms_per_step": 1e3 * pm["decode_s"]
                / pm["decode_calls"],
                "tok_per_s": plain["stats"]["tok_per_s"]}}


def block_input(params, cfg, layer: int, norm: str, toks, dev):
    """The path's own input to one block of ``layer``: the tokens
    embedded and normed by its ``norm`` ("ln1" before the mixer, "ln2"
    before the FFN)."""
    import torch

    from repro_torch.models.layers import embed, rmsnorm

    p = params["layers"][layer]
    x = torch.as_tensor(toks, device=dev)
    return rmsnorm(p[norm], embed(params["embed"], x), cfg.norm_eps)


def block_close(got, want, what: str, spread: float = 0.0) -> float:
    """Finite, and in bf16 within ``K7_TOL["bfloat16"]`` of max(1,
    |plain|), as K7's bf16 cases: one bf16 step of each value (the
    attention outputs reach 32 and more, the reference's init scaling wk
    and wv by their K dim); in f32 within ``K7_TOL["float32"]`` of the
    block output's scale, max(1, max |plain|) (K7's f32 cases hold 1e-5
    on unit-scale inputs), plus twice ``spread``, how far the plain
    version itself moves when it takes the kernel's summation order ->
    the max abs difference."""
    import torch

    d = (got.float() - want.float()).abs()
    err = float(d.max())
    if got.dtype == torch.bfloat16:
        bound = K7_TOL["bfloat16"] * want.float().abs().clamp_min(1.0)
    else:
        bound = K7_TOL["float32"] * max(1.0, float(want.abs().max())) \
            + 2 * spread
    check(bool(torch.isfinite(got).all()) and bool((d <= bound).all()),
          f"{what}: differs from its plain version by {err}")
    return err


def mamba_block_check(params, cfg, toks, dev) -> dict:
    """Layer 0's Mamba mixer on K8 against its plain scan: a prefill of
    toks[:, :-1], then one decode step from each one's state; outputs by
    ``block_close``, states within ``K8_TOL`` x (1 + |plain|), the conv
    state exact."""
    import torch

    from repro_torch.models import ssm

    p = params["layers"][0]["mamba"]
    h = block_input(params, cfg, 0, "ln1", toks, dev)
    errs, states = {}, {}
    with torch.no_grad():
        for step, hx in (("prefill", h[:, :-1]), ("decode", h[:, -1:])):
            out = {b: ssm.mamba_apply(p, hx, cfg, state=states.get(b),
                                      return_state=True, backend=b)
                   for b in ("cuda", "interpret")}
            (o, st), (po, pst) = out["cuda"], out["interpret"]
            states = {b: out[b][1] for b in out}
            dh = (st["h"] - pst["h"]).abs()
            check(bool((dh <= K8_TOL * (1 + pst["h"].abs())).all())
                  and torch.equal(st["conv"], pst["conv"]),
                  f"Mamba block {step}: states differ by {float(dh.max())}")
            errs[step] = {"out": block_close(o, po, f"Mamba block {step}"),
                          "h": float(dh.max())}
    return errs


def attn_close(got: dict, dev, what: str, call=None) -> dict:
    """K7 (``got["cuda"]``) against the plain attention
    (``got["interpret"]``) by ``block_close``; in f32 with the spread of
    the plain decomposition of the kernel's call (``call`` = (q, k, v,
    skv, kw), ``k7_split_ref``) -> {"err"[, "split_spread",
    "vs_split"]}."""
    import torch

    if got["cuda"].dtype != torch.float32:
        return {"err": block_close(got["cuda"], got["interpret"], what)}
    q, k, v, skv, kw = call
    split = k7_split_ref(dev, q.float(), k.float(), v.float(), skv,
                         **kw).float()
    spread = float((split - got["interpret"].float()).abs().max())
    return {"err": block_close(got["cuda"], got["interpret"], what, spread),
            "split_spread": spread,
            "vs_split": float((got["cuda"].float() - split).abs().max())}


def self_block_check(p, h, cfg, dev, what: str, *, causal: bool = True,
                     n_decode: int = 1, max_seq: int = LM_MAX_SEQ) -> dict:
    """A self-attention block's attention (before the output projection)
    on K7 against the plain attention, on its normed input ``h`` [B, S +
    n_decode, d], as the serving path calls them: the prefill of the
    first S positions (causal with the config's window, or the encoder's
    non-causal call), its last T keys written to slots 0..T-1 of a [B,
    T] cache (T = min(max_seq, window) with a window), then ``n_decode``
    decode steps, each writing its key (at index % T with a window) and
    attending the cache: non-causal over the min(index + 1, T) written
    slots with a window, else causal at q_offset = index.  Each call by
    ``attn_close``."""
    import torch

    from repro_torch.models import attention as attn

    window = cfg.sliding_window
    B, S = h.shape[0], h.shape[1] - n_decode
    T = min(max_seq, window) if window else max_seq
    kv = {n: torch.zeros((B, T, cfg.num_kv_heads, cfg.head_dim),
                         dtype=torch.bfloat16, device=dev) for n in "kv"}
    out = {}
    with torch.no_grad():
        pos = torch.arange(S, device=dev)
        q = attn.project_q(p, h[:, :S], cfg, pos)
        k, v = attn.project_kv(p, h[:, :S], cfg, pos)
        got = {b: attn.prefill_attention(q, k, v, backend=b, causal=causal,
                                          window=window)
               for b in ("cuda", "interpret")}
        out["prefill"] = attn_close(got, dev, f"{what} prefill", (
            q, k, v, S, dict(causal=causal, window=window, q_offset=0)))
        attn.cache_update_tree(kv, k[:, -T:], v[:, -T:], 0)
        for t in range(n_decode):
            i = S + t
            pos = torch.arange(i, i + 1, device=dev)
            q = attn.project_q(p, h[:, i:i + 1], cfg, pos)
            k, v = attn.project_kv(p, h[:, i:i + 1], cfg, pos)
            attn.cache_update_tree(kv, k, v, i, window=window)
            got = {b: attn.decode_attention_tree(q, kv, i, backend=b,
                                                 window=window)
                   for b in ("cuda", "interpret")}
            kw, skv = ((dict(causal=False, window=0, q_offset=0),
                        min(i + 1, T)) if window else
                       (dict(causal=True, window=0, q_offset=i), T))
            out[f"decode_{i}"] = attn_close(got, dev, f"{what} decode {i}",
                                            (q, kv["k"], kv["v"], skv, kw))
    return out


def moe_block_check(params, cfg, toks, experts, dev, *, layer: int = 0,
                    x=None) -> dict:
    """Layer 0's MoE FFN (``moe_apply``: capacity dispatch, the held
    experts' batched SwiGLU, combine) against a plain gather: each held
    expert's SwiGLU on the tokens its routing keeps, weighted by their
    gates and summed in f32, by ``block_close``, over the prefill's
    tokens toks[:, :-1] (or ``layer``'s, on its normed input ``x`` when
    the caller has it); the SwiGLU's silu is the model's
    (``models.layers.silu``, the reference's rounding).  The routing is
    the layer's own ``route``, held to the reference's on the CPU."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import silu

    p = params["layers"][layer]["ffn"]
    if x is None:
        x = block_input(params, cfg, layer, "ln2", toks[:, :-1], dev)
    B, S, d = x.shape
    T, k = B * S, cfg.num_experts_per_tok
    lo, hi = moe.expert_range(experts, cfg.num_experts)
    with torch.no_grad():
        got, aux = moe.moe_apply(p, x, cfg, experts=experts)
        g = min(moe.GROUP_SIZE, T)
        r = moe.route(p["router"], x.reshape(T // g, g, d), cfg)
        ids, keep = r["experts"].reshape(T, k), r["keep"].reshape(T, k)
        gates, xt = r["gates"].reshape(T, k), x.reshape(T, d)
        want = torch.zeros((T, d), dtype=torch.float32, device=dev)
        for e in range(lo, hi):
            tok, slot = torch.nonzero((ids == e) & keep, as_tuple=True)
            xe = xt[tok]
            y = (silu(xe @ p["wg"][e - lo]) * (xe @ p["wu"][e - lo])
                 ) @ p["wd"][e - lo]
            want.index_add_(0, tok, gates[tok, slot, None] * y.float())
    return {"out": block_close(got, want.to(x.dtype).reshape(B, S, d),
                               f"layer {layer} MoE block"),
            "drop_frac": float(aux["moe_drop_frac"]),
            "held_slots": int(((ids >= lo) & (ids < hi) & keep).sum())}


def path_hybrid_serve(dev):
    """``ServeEngine`` with Jamba-1.5-Large at every published width
    (d_model 8,192, 64 query heads over 8 KV heads of 128, d_ff 24,576,
    d_inner 16,384, d_state 16, d_conv 4, dt_rank 512, vocab 65,536, 16
    experts top-2), one 8-layer period (7 Mamba mixers, attention at
    slot 4, MoE at slots 0, 2, 4, 6), weights from ``torch.Generator``
    seed 0, batch_slots 4, max_seq 1,024, the two rounds of ``HY_ROUNDS``
    in one ``run`` per engine (``hybrid_serve``: K8's discretizing entry
    7 x (2 + 96) = 686 launches, K7 98), twice:

    * bf16 with experts 0-7 (the deployment's share of a card, the main
      path the kernels line counts): timings and peak memory.  With
      seeded weights at this width one bf16 rounding flip anywhere
      moves the logits by O(1) (the reference's init gives attention
      scores a spread near 360 without QK-norm, so near-ties decide
      which key a query takes, and MoE routing has near-ties too), so
      no end-to-end gate holds in bf16.  The gates are per block, on
      the path's own input (round 1's prompts embedded and normed, B =
      4, S = 512, then one decode step): layer 0's Mamba mixer on K8
      against its plain scan, layer 4's attention on K7 against plain
      attention, layer 0's MoE FFN against a plain per-expert gather.
      The logits against ``backend="interpret"``, tokens and teacher
      forcing are reported.
    * f32 with experts 0-1 (f32 weights take 45.7 GB): the same rounds,
      where the plain path's gates hold: each round's prefill logits
      within ``LM_LOGIT_TOL`` of ``interpret``; each request's tokens the
      same, or first differing where the plain path's own logits along
      its tokens put the two within 2 x ``LM_LOGIT_TOL``; round 2 against
      a teacher-forced forward over its 192 + 64 = 256 positions.  The
      MoE capacity drops depend on the grouping, so that gate holds a
      rerun of round 2 with no drop possible (``capacity_factor`` = E /
      k): agreement on at least ``LM_AGREE`` of the positions, each miss
      where the forward's top two lie within 2 x ``LM_LOGIT_TOL``; at
      the published capacity the agreement is reported.

    The phase line is printed before the gates that follow the runs.
    -> the bf16 run's launches per kernel."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.models.registry import init_params
    from repro_torch.serve.engine import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = hybrid_config()
    report, gates = {}, []
    for dtype, experts in ((torch.bfloat16, HY_EXPERTS),
                           (torch.float32, HY_F32_EXPERTS)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = init_params(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(HY_SEED), device=dev, dtype=dtype,
                             experts=experts)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        runs = hybrid_serve(cfg, params, experts, dev)
        rep = dict(experts=[experts.start, experts.stop - 1],
                   weights_gb=sum(x.numel() * x.element_size()
                                  for x in _leaves(params)) / 1e9,
                   init_s=init_s, **run_fields(runs))
        batches = lm_batches(runs["cuda"]["reqs"])
        errs, drops = [], {}
        for i, (S, toks, _) in enumerate(batches):
            lg, aux = prefill_logits(params, cfg, toks[:, :S], "cuda",
                                     experts, dev)
            plg, _ = prefill_logits(params, cfg, toks[:, :S], "interpret",
                                    experts, dev)
            check(bool(torch.isfinite(lg).all()), "non-finite logits")
            errs.append(max_abs(lg, plg))
            drops[f"prefill_round_{i + 1}"] = float(aux["moe_drop_frac"])
        rep["prefill_logit_err"] = errs
        diffs = first_diffs(params, cfg, runs["cuda"]["reqs"],
                            runs["interpret"]["reqs"], experts, dev)
        rep["requests_differing"], rep["first_diffs"] = len(diffs), diffs
        published = teacher_forcing(params, cfg, runs["cuda"]["reqs"][
            LM_SLOTS:], experts, dev)
        rep["published_capacity"] = {
            "capacity_factor": cfg.capacity_factor,
            "teacher_forcing_agree": float(np.mean(published["agree"])),
            "teacher_forcing_miss_margins": [
                m["margin"] for m in published["misses"]],
            "moe_drop_frac_sum": dict(
                drops, teacher_forcing=published["drop_frac_sum"])}
        if dtype == torch.bfloat16:
            main_launches = runs["cuda"]["launches"]
            S, toks, _ = batches[0]
            toks = toks[:, :S + 1]
            i = cfg.attn_period // 2
            rep["block_err"] = {
                "mamba": mamba_block_check(params, cfg, toks, dev),
                "attention": self_block_check(
                    params["layers"][i]["attn"],
                    block_input(params, cfg, i, "ln1", toks, dev), cfg, dev,
                    f"layer {i} attention"),
                "moe": moe_block_check(params, cfg, toks, experts, dev)}
        else:
            free = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts
                / cfg.num_experts_per_tok)
            eng = ServeEngine(free, params, batch_slots=LM_SLOTS,
                              max_seq=LM_MAX_SEQ, backend="cuda", device=dev,
                              experts=experts)
            free_reqs = hybrid_requests(cfg.vocab_size)[LM_SLOTS:]
            for r in free_reqs:
                eng.submit(r)
            eng.run(max_steps=HY_ROUNDS[1][2])
            del eng
            tf = teacher_forcing(params, free, free_reqs, experts, dev)
            rep["teacher_forcing"] = {
                "capacity_factor": free.capacity_factor,
                "agree": float(np.mean(tf["agree"])),
                "agree_by_request": tf["agree"], "misses": tf["misses"],
                "moe_drop_frac_sum": tf["drop_frac_sum"]}
            gates += [
                (max(errs) <= LM_LOGIT_TOL,
                 f"f32 prefill logits differ by {errs} > {LM_LOGIT_TOL}"),
                (all(abs(d["margin"]) <= 2 * LM_LOGIT_TOL for d in diffs),
                 f"f32 tokens first differ outside the margin: {diffs}"),
                (all(m["margin"] <= 2 * LM_LOGIT_TOL for m in tf["misses"]),
                 f"decode misses teacher forcing outside the margin: "
                 f"{tf['misses']}"),
                (np.mean(tf["agree"]) >= LM_AGREE,
                 f"decode against teacher forcing agrees on "
                 f"{np.mean(tf['agree'])}")]
        report["bf16" if dtype == torch.bfloat16 else "f32"] = rep
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "path_hybrid_serve", "arch": HY_ARCH,
          "num_layers": cfg.num_layers, "batch_slots": LM_SLOTS,
          "max_seq": LM_MAX_SEQ,
          "prompt_lens": [len(r.prompt) for r in hybrid_requests(
              cfg.vocab_size)],
          "max_new_tokens": [new for _, _, new in HY_ROUNDS],
          "logit_tol": LM_LOGIT_TOL, **report, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return main_launches


# ------------------------------- slice 7: the compiler and K9 (bgemm)

K9_NAMES = ("bgemm_sign_pack<{x}, {w}>", "bgemm_wgmma_kernel")
INT8_OPS_PER_S = 1979e12            # H100 SXM int8 dense (data sheet)
# name, B, K, N, dtype, whether 0 / -0.0 / NaN are planted in x and w
K9_CASES = (
    ("ragged_planted", 37, 200, 45, "float32", True),
    ("ragged_planted_bf16", 37, 200, 45, "bfloat16", True),
    ("bf16", 256, 1000, 96, "bfloat16", False),
    ("1024x128x128", 1024, 128, 128, "float32", False),
    ("4096^3", 4096, 4096, 4096, "float32", False),
)
K9_TIMED = (("1024x128x128", 1024, 128, 128), ("4096^3", 4096, 4096, 4096))

# path_generate: the quickstart program (examples/quickstart.py) at its
# own size, then the same data on Tofino (a MAT, so K4)
GEN_BUDGET, GEN_N_INIT, GEN_SEED = 14, 6, 0
TOFINO_BUDGET, TOFINO_N_INIT = 8, 4
TOFINO_ALGOS = ("svm", "logreg")
GEN_BATCH, GEN_TILE, GEN_CHUNK, GEN_PASSES = 1024, 16, 997, 3
MAT_MISMATCH = 0.03                  # the reference's 512-bin LUT bound
# the trainer on the card (a CUDA graph after its warm-up steps) against
# the same Adam steps on the CPU from one init and schedule: the
# quickstart's pick, 20 steps; logits within 1e-4 x (1 + |CPU|) (cuBLAS
# and the CPU's BLAS sum in other orders)
TRAIN_CHECK = dict(widths=[7, 24, 4, 12, 16, 16, 16, 4, 4, 4, 2],
                   lr=0.016, batch=128, nsteps=20)
TRAIN_TOL = 1e-4


def bgemm_inputs(dev, B, K, N, dtype, planted, seed):
    """Seeded normal x [B, K] and w [K, N] on ``dev`` in ``dtype``; with
    ``planted``, 0.0, -0.0 and NaN each at 1 % of both operands'
    positions."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev)
    if planted:
        for t in (x, w):
            u = torch.rand(t.shape, generator=g, device=dev)
            t[u < 0.01] = 0.0
            t[(u >= 0.01) & (u < 0.02)] = -0.0
            t[(u >= 0.02) & (u < 0.03)] = float("nan")
    dt = getattr(torch, dtype)
    return x.to(dt).contiguous(), w.to(dt).contiguous()


def k9_bound(B, K, N, itemsize):
    """x and w read once, out (int32) written once, over the HBM rate;
    2BKN operations over the int8 tensor-core rate."""
    moved = itemsize * (B * K + K * N) + 4 * B * N
    t_b = moved / HBM_BYTES_PER_S * 1e3
    t_o = 2.0 * B * K * N / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernels_check_bgemm(dev):
    """K9 against its plain version (``binarized_gemm_ref``) on the card,
    int for int, at every case of ``K9_CASES`` (ragged B, K, N; 0, -0.0
    and NaN planted; bf16; 1,024 x 128 x 128; 4,096^3); the result has
    K's parity.  The sign launch's int8 scratch is held against
    ``sign_pack_ref`` byte for byte in the same call.  -> {"binarized_gemm":
    max abs error (0)}."""
    import torch

    from repro_torch.kernels import _ext
    from repro_torch.kernels.binarized_gemm import (
        K_TILE,
        binarized_gemm_launch,
        binarized_gemm_ref,
        sign_pack_ref,
    )

    rows, worst = [], 0.0
    for i, (name, B, K, N, dtype, planted) in enumerate(K9_CASES):
        x, w = bgemm_inputs(dev, B, K, N, dtype, planted, 300 + i)
        got = binarized_gemm_launch(x, w)
        want = binarized_gemm_ref(x, w)
        xs_want, wt_want = sign_pack_ref(x, w, K_TILE)
        xs, wt = torch.empty_like(xs_want), torch.empty_like(wt_want)
        _ext.extension().binarized_gemm(x, w, xs, wt, torch.empty_like(got))
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and tuple(got.shape) == (B, N),
              f"K9 {name}: {got.dtype} {tuple(got.shape)}")
        check(torch.equal(xs, xs_want) and torch.equal(wt, wt_want),
              f"K9 {name}: the int8 signs differ from sign_pack_ref")
        err = max_abs(got, want)
        check(torch.equal(got, want.to(torch.int32)),
              f"K9 {name}: differs from the plain version by {err}")
        check(bool(((got - K) % 2 == 0).all()), f"K9 {name}: parity of K")
        worst = max(worst, err)
        rows.append({"case": name, "shape": [B, K, N], "dtype": dtype,
                     "planted": planted, "max_abs_err": err,
                     "kp": int(xs.shape[1]),
                     "nan_in_x": int(torch.isnan(x.float()).sum())})
        del x, w, got, want, xs, wt, xs_want, wt_want
    emit({"phase": "kernels_check_bgemm", "tol": "exact int32", "cases": rows})
    return {"binarized_gemm": worst}


def kernels_time_bgemm(dev):
    """K9 at 1,024 x 128 x 128 and 4,096^3 (f32): wrapper ms over 50
    calls (CUDA events), device ms (profiler: the sign launch and the
    product, summed per call), the plain version's ms and the bound;
    ``library_ms``: ``torch._int_mm`` on pre-signed int8 operands, which
    leaves out the sign pass K9 includes, the faster of its second
    operand row-major and column-major (both timed, both checked equal
    to K9's result).  -> {config: numbers}."""
    import torch

    from repro_torch.kernels.binarized_gemm import (
        binarized_gemm_launch,
        binarized_gemm_ref,
        sign_pm1,
    )

    out = {}
    for name, B, K, N in K9_TIMED:
        x, w = bgemm_inputs(dev, B, K, N, "float32", False, 7)
        k9 = lambda: binarized_gemm_launch(x, w)  # noqa: E731
        names = [n.format(x="float", w="float") for n in K9_NAMES]
        seen = kernel_device_ms({names[0]: k9, **{n: lambda: None
                                                  for n in names[1:]}})
        parts = {n: seen[n]["ms"] for n in names}
        xs = sign_pm1(x).to(torch.int8)
        layouts = {"row_major": sign_pm1(w).to(torch.int8)}
        layouts["column_major"] = layouts["row_major"].t().contiguous().t()
        got = k9()
        lib = {}
        for lay, ws in layouts.items():
            check(torch.equal(torch._int_mm(xs, ws), got),
                  f"K9 {name}: torch._int_mm ({lay}) differs")
            lib[lay] = time_ms(lambda: torch._int_mm(xs, ws),
                               TIMED_LAUNCHES)
        fast = min(lib, key=lib.get)
        out[name] = dict(
            ms=time_ms(k9, TIMED_LAUNCHES),
            kernel_ms=(sum(parts.values()) if None not in parts.values()
                       else None),
            kernel_parts_ms=parts,
            plain_ms=time_ms(lambda: binarized_gemm_ref(x, w), 5),
            library_ms=lib[fast], library_layouts_ms=lib,
            library=f"torch._int_mm on pre-signed int8 (no sign pass), "
                    f"second operand {fast.replace('_', '-')}",
            bound=k9_bound(B, K, N, 4), shape=[B, K, N])
        del x, w, xs, layouts, got
        torch.cuda.empty_cache()
    emit({"phase": "kernels_time_bgemm", **out, "nvidia_smi": nvidia_smi()})
    return out


def quickstart_loader():
    """The quickstart's @DataLoader (examples/quickstart.py)."""
    from repro_torch.core.alchemy import DataLoader
    from repro_torch.data import netdata

    @DataLoader
    def wrapper_func():
        d = netdata.make_ad_dataset(features=7, n_train=4096, n_test=2048)
        return {"data": {"train": d.train_x, "test": d.test_x},
                "labels": {"train": d.train_y, "test": d.test_y},
                "feature_names": d.feature_names,
                "name": "anomaly_detection"}

    return wrapper_func


def generate_run(dev, kind: str, algos, budget: int, n_init: int):
    """One ``facade.generate`` of the quickstart's model on ``kind`` ->
    (its ModelResult, the trainer's buckets, wall seconds, the Model)."""
    from repro_torch import facade
    from repro_torch.core.alchemy import Model, Platforms
    from repro_torch.core.traincache import CandidateCache

    model = Model({"optimization_metric": ["f1"], "algorithm": list(algos),
                   "name": "anomaly_detection",
                   "data_loader": quickstart_loader()})
    platform = getattr(Platforms, kind)()
    platform.constrain(performance={"throughput": 1, "latency": 500},
                       resources={"rows": 16, "cols": 16})
    platform.schedule(model)
    t = time.perf_counter()
    result = facade.generate(platform, budget=budget, n_init=n_init,
                             seed=GEN_SEED, cache=CandidateCache(),
                             device=dev.type)
    wall = time.perf_counter() - t
    r = result["anomaly_detection"]
    # each trained bucket once (a fresh cache: every candidate was trained)
    buckets = {id(b): b for b in (o.info["trained"].bucket
                                  for o in r.history) if b is not None}
    return r, list(buckets.values()), wall, model


def trainer_check(dev, data) -> float:
    """``mlalgos.mlp_train`` on ``dev`` (replaying its step graph after
    the warm-up) against the CPU from one seeded init and schedule:
    ``TRAIN_CHECK`` steps, the test set's logits within ``TRAIN_TOL``.
    -> max abs logit difference."""
    import numpy as np
    import torch

    from repro_torch.core import mlalgos

    c = TRAIN_CHECK
    init = mlalgos._mlp_init(torch.Generator().manual_seed(0), c["widths"])
    idx = mlalgos.minibatch_schedule(1, len(data.train_x), c["nsteps"],
                                     c["batch"])
    logits = []
    for d in (dev, torch.device("cpu")):
        got = mlalgos.mlp_train(
            [{k: t[None].to(d) for k, t in layer.items()} for layer in init],
            None, torch.as_tensor(data.train_x, device=d),
            torch.as_tensor(data.train_y.astype(np.int64), device=d),
            idx.to(d), torch.tensor([c["lr"]], device=d))
        logits.append(mlalgos.mlp_forward(
            [{k: t[0] for k, t in layer.items()} for layer in got],
            torch.as_tensor(data.test_x, device=d)).cpu())
    err = max_abs(logits[0], logits[1])
    check(bool(((logits[0] - logits[1]).abs()
                <= TRAIN_TOL * (1 + logits[1].abs())).all()),
          f"the card's trainer differs from the CPU's by {err}")
    return err


def serve_generated(dev, pipe, X):
    """The test set tiled ``GEN_TILE`` times through the stateless
    ``PacketServeEngine`` at B = ``GEN_BATCH``, ``GEN_PASSES`` passes ->
    (median row, verdicts of one pass)."""
    import numpy as np

    from repro_torch.serve.packet_engine import PacketServeEngine

    stream = np.tile(X, (GEN_TILE, 1))
    chunks = [stream[i:i + GEN_CHUNK]
              for i in range(0, len(stream), GEN_CHUNK)]
    runs, v = [], None
    for _ in range(GEN_PASSES):
        eng = PacketServeEngine(pipe, feature_dim=X.shape[1],
                                max_batch=GEN_BATCH, depth=2,
                                device=dev.type)
        v = np.concatenate(list(eng.serve_stream(chunks)))
        runs.append(row_of(eng))
    med = sorted(runs, key=lambda r: r["pkt_per_s"])[len(runs) // 2]
    return dict(med, pkt_per_s_runs=sorted(r["pkt_per_s"] for r in runs),
                n_packets=len(stream)), v


def path_generate(dev):
    """The paper's entry point on the card: the quickstart program
    (``make_ad_dataset(features=7, n_train=4096, n_test=2048)``,
    ``Platforms.Taurus()`` 16 x 16 at 1 GPkt/s and 500 ns, a DNN,
    ``generate(budget=14, n_init=6, seed=0)``) through
    ``repro_torch.facade``: every candidate trained on the card, the
    pipeline compiled for the kernels.  Gates: ``compiled_backend`` is
    "cuda"; ``verify`` (K3's verdicts against the trained model) differs
    only on rows whose top-two logit margin is within 1e-4; the served
    verdicts (``PacketServeEngine`` at B = 1,024) equal the pipeline's.
    Then a Tofino run on the same data (svm or logreg as a MAT on K4,
    budget 8): K4's verdicts equal the plain walk on the CPU exactly, and
    ``verify`` stays within the reference's 0.03 quantization bound.  Last
    ``trainer_check`` holds the trainer on the card to the CPU's.
    -> launches per kernel over the phase's generate and serving runs."""
    import numpy as np

    from repro_torch.core import codegen
    from repro_torch.kernels import _ext

    data = quickstart_loader()()
    X = data.test_x
    want_backend = "cuda" if dev.type == "cuda" else "cpu-ref"
    _ext.reset_launches()
    report = {}
    for kind, algos, budget, n_init, want_kernel in (
            ("Taurus", ("dnn",), GEN_BUDGET, GEN_N_INIT,
             "fused_mlp_classify"),
            ("Tofino", TOFINO_ALGOS, TOFINO_BUDGET, TOFINO_N_INIT,
             "mat_lut_classify")):
        r, buckets, wall, model = generate_run(dev, kind, algos, budget,
                                               n_init)
        pipe = r.pipeline
        check(pipe.compiled_backend == want_backend,
              f"{kind}: the pipeline serves on {pipe.compiled_backend}")
        before = _ext.LAUNCHES[want_kernel]
        outside, near = pipe.mismatches(X)
        check(_ext.LAUNCHES[want_kernel] == before + 1,
              f"{kind}: verify did not run on {want_kernel}")
        got = pipe(X)
        row = {"algorithm": r.algorithm, "config": r.trained.config,
               "f1": r.value, "iterations": len(r.history),
               "report": r.report.resources,
               "latency_ns": r.report.latency_ns,
               "compiled_backend": pipe.compiled_backend,
               "stages": [s.kind for s in pipe.stages],
               "dse_wall_s": r.wall_s, "generate_s": wall,
               "verify_outside_margin": outside, "verify_within_margin": near}
        if kind == "Taurus":
            check(outside == 0, f"Taurus: {outside} verdicts differ from the "
                  "trained model outside the 1e-4 margin")
        else:
            plain = codegen.generate_pipeline(
                "tofino", "plain", r.trained, r.report,
                model.data().train_x, exec_backend="interpret",
                device="cpu")
            check(np.array_equal(got, plain(X)),
                  "Tofino: K4's verdicts differ from the plain walk")
            frac = pipe.verify(X, max_mismatch_frac=MAT_MISMATCH)
            row["verify_frac"] = frac
        lanes = sum(b["lanes"] for b in buckets)
        train_s = sum(b["s"] for b in buckets)
        row.update(
            dnn_candidates_trained=lanes, trainer_s=train_s,
            trainer_ms_per_candidate=train_s / lanes * 1e3 if lanes else None,
            buckets=[{"lanes": b["lanes"], "nsteps": b["nsteps"],
                      "batch": b["batch"], "widths": b["widths"],
                      "ms": b["s"] * 1e3} for b in buckets])
        served, v = serve_generated(dev, pipe, X)
        check(np.array_equal(v, np.tile(got, GEN_TILE)),
              f"{kind}: served verdicts differ from the pipeline's")
        row["serve"] = served
        report[kind] = row
    launches = dict(_ext.LAUNCHES)
    report["trainer_vs_cpu_max_abs"] = trainer_check(dev, data)
    emit({"phase": "path_generate", **report, "launches": launches,
          "nvidia_smi": nvidia_smi()})
    return launches



# -------------------------- slice 13: the online loop, fusion, Table 3

# examples/hot_swap.py's configuration
ONLINE_PACKETS, ONLINE_CHUNK, ONLINE_SLOTS, ONLINE_SPAN_S = \
    24_000, 512, 2048, 120.0
ONLINE_SEEDS = {"train": 0, "serve": 1, "recovery": 2}
ONLINE_SEARCH = dict(algorithms=["dnn"], budget=6, n_init=3, seed=0)
ONLINE_DETECTOR = dict(alpha=0.25, threshold=1.9, patience=3)
ONLINE_BUFFER = 24
ONLINE_WAIT_S = 600
ONLINE_F1 = {"pre_drift": 0.85, "post_drift": 0.5, "post_swap": 0.85}
# benchmarks/table4_fusion.py's configuration
FUSION_DATA = dict(features=7, n_train=8192, n_test=4096)
FUSION_HIDDEN, FUSION_EPOCHS, FUSION_BATCH = [24, 16], 10, 1024


def serving_row(lat_s: list, rows: list) -> dict:
    """Per-flush host latencies (submit to verdicts) and their packet
    counts -> batches, pkt/s over their sum, p50 / p99 ms."""
    import numpy as np

    if not lat_s:
        return {"batches": 0, "pkt_per_s": None, "lat_p50_ms": None,
                "lat_p99_ms": None}
    lat = np.asarray(lat_s)
    return {"batches": len(lat), "pkt_per_s": float(sum(rows) / lat.sum()),
            "lat_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "lat_p99_ms": float(np.percentile(lat, 99) * 1e3)}


def plain_online_twin(pipes, packets, offset):
    """The plain twin of path_online's served stream, on CPU tensors: the
    flow table walked in arrival order over every packet the engine
    served (``flow_update_ref``; batching does not change it), then K1's
    plain classifier (``suffix_scores``) of ``pipes[0]`` on the rows
    before the install ``offset`` and of ``pipes[1]`` from it on ->
    (keys, regs, scores [N, classes] numpy)."""
    import torch

    from repro_torch.kernels import fused_flow as ff
    from repro_torch.kernels.flow_update import flow_update_ref

    cpu = torch.device("cpu")
    lowered = [multi_lowered(p.stages, cpu) for p in pipes]
    tp = lowered[0][0][0]
    check(all(lw[0][0][:5] == tp[:5] for lw in lowered), "path_online: the "
          "served pipelines update their tables differently")
    fk, ru = pipes[0].groups[0][:2]
    x = torch.as_tensor(packets)
    upd, bins = ru.prepare(x)
    keys, regs, f = flow_update_ref(
        torch.full((ru.spec.n_slots,), -1, dtype=torch.int32),
        torch.zeros((ru.spec.n_slots, ru.spec.width)), fk.apply_keys(x),
        upd, bins, torch.ones(len(x), dtype=torch.int32),
        n_counters=tp.n_counters, n_ewma=tp.n_ewma, alpha=tp.alpha)
    scores = []
    for ((tpk,), sp, params, _), rows in zip(
            lowered, (slice(0, offset), slice(offset, None))):
        # each model reads the table out as its own lowering does
        sc = ff.suffix_scores(ff.suffix_readout(f[rows], tpk), params, sp)
        scores.append(sc[:, :sp.num_classes] if sp.kind == "mlp" else sc)
    return keys, regs, torch.cat(scores, 0).numpy()


def path_online(dev):
    """The online loop on the card at ``examples/hot_swap.py``'s
    configuration: concept_drift streams of 24,000 packets (seed 0 to
    train, on phase A only; 1 to serve; 2, from its drift on, for the
    recovery), 2,048 slots, chunks of 512, depth 2.  Each model comes from
    ``stream_feature_dataset`` (the register replay on K2) and
    ``dse.retrain_model`` (Taurus 16 x 16, dnn, budget 6, n_init 3, seed
    0; trained on the card), its pipeline checked by ``mismatches`` (K3)
    and served fused (K1).  A ``DriftDetector(alpha 0.25, threshold 1.9,
    patience 3)`` on the packet-length column against the phase-A
    snapshot drives a ``HotSwapController(buffer_windows=24)`` whose
    retrain runs on a worker thread (its own CUDA stream) while the
    serving thread goes on; while the retrain still runs after the
    stream, a probe engine (the initial pipeline, telemetry off) serves
    the stream again so that serving under a retrain is measured.
    The retrain is held from parking until the drifting stream is served
    (the example's gates assume a retrain that outlasts the stream; the
    held time is reported, zero while the search is the slower).  Gates,
    the example's: one episode, no errors, ``wait(600)``; the swap
    installs at the next ``flush()``; keys and registers bit-identical
    across the install; one verdict per packet on both sides of the
    swap; F1 > 0.85 before the drift, < 0.5 on drifted traffic up to the
    install, > 0.85 after the swap.
    Also: the phase-A replay on K2 gives the same feature rows, bit for
    bit, as the plain version on the CPU; and every verdict K1 served,
    both models', is held under the margin rule against the plain twin
    (``plain_online_twin``: the sequential table walk and K1's plain
    classifier, switched at the install's packet offset), the engine's
    final keys and registers equal to the twin's bit for bit.
    -> launches."""
    import numpy as np
    import torch

    from repro_torch.core import codegen, dse, mlalgos
    from repro_torch.core.alchemy import Platforms
    from repro_torch.core.traincache import CandidateCache
    from repro_torch.data import traffic
    from repro_torch.flowstate import (
        DriftDetector,
        DriftSnapshot,
        StatefulPipeline,
    )
    from repro_torch.kernels import _ext
    from repro_torch.serve import HotSwapController, PacketServeEngine
    from repro_torch.testing import verdict_mismatches

    platform = Platforms.Taurus()
    platform.constrain(resources={"rows": 16, "cols": 16})
    stages, names = traffic.flow_feature_stages(n_slots=ONLINE_SLOTS)
    cache = CandidateCache()
    info, pipes = {}, {}

    def drift_index(stream) -> int:
        return int(np.searchsorted(stream.times,
                                   ONLINE_SPAN_S * traffic.DRIFT_FRAC))

    def search_pipeline(stream, tag):
        t0 = time.perf_counter()
        ds, mu, sd = traffic.stream_feature_dataset(
            stream, stages, names, sample_every=2, device=dev.type)
        t1 = time.perf_counter()
        res = dse.retrain_model(platform, ds, name=tag, cache=cache,
                                device=dev.type, **ONLINE_SEARCH)
        outside, near = res.pipeline.mismatches(ds.test_x)
        check(outside == 0, f"{tag}: {outside} verdicts of the generated "
              "pipeline differ from its model outside the 1e-4 margin")
        suffix = traffic.fold_input_standardization(
            codegen.taurus_stages(res.trained), mu, sd)
        pipe = StatefulPipeline(list(stages) + suffix, backend="cuda",
                                device=dev.type)
        info[tag] = {"rows": len(ds.train_x) + len(ds.test_x),
                     "replay_s": t1 - t0, "dse_s": res.wall_s,
                     "algorithm": res.algorithm, "f1": res.value,
                     "widths": res.trained.topology.get("widths"),
                     "verify_within_margin": near,
                     "thread": threading.current_thread().name,
                     "stream": (str(torch.cuda.current_stream(dev))
                                if dev.type == "cuda" else None),
                     "wall_s": time.perf_counter() - t0}
        pipes[tag] = pipe
        return pipe

    def windows_to_stream(windows, flow_labels):
        pkts = np.concatenate(windows, 0)
        fids = pkts[:, traffic.COL_FLOW].astype(np.int32)
        labels = np.array([flow_labels.get(int(f), 0) for f in fids],
                          np.int32)
        return traffic.PacketStream("concept_drift-retrain", pkts, labels,
                                    fids, dict(flow_labels))

    def serve_chunk(eng, chunk, lat, rows):
        t = time.perf_counter()
        eng.submit(chunk)
        v = eng.flush()
        lat.append(time.perf_counter() - t)
        rows.append(len(chunk))
        return v

    train = traffic.make_stream("concept_drift", n_packets=ONLINE_PACKETS,
                                seed=ONLINE_SEEDS["train"])
    phase_a = train.slice(0, drift_index(train))
    # the replay on K2 against its plain version on the CPU, bit for bit
    on_card = traffic.stream_feature_dataset(phase_a, stages, names,
                                             device=dev.type)
    plain = traffic.stream_feature_dataset(phase_a, stages, names,
                                           device="cpu")
    for a, b in zip((on_card[0].train_x, on_card[0].test_x, *on_card[1:]),
                    (plain[0].train_x, plain[0].test_x, *plain[1:])):
        check(a.shape == b.shape and np.array_equal(
            a.view(np.uint32), b.view(np.uint32)),
            "path_online: the K2 replay's feature rows differ from the "
            "plain version's")

    _ext.reset_launches()
    initial = search_pipeline(phase_a, "phase-a")
    snapshot = DriftSnapshot.from_packets(
        phase_a.packets, cols=(traffic.COL_LEN,), window=ONLINE_CHUNK)
    serve = traffic.make_stream("concept_drift", n_packets=ONLINE_PACKETS,
                                seed=ONLINE_SEEDS["serve"])
    ev_drift = drift_index(serve)
    rec = traffic.make_stream("concept_drift", n_packets=ONLINE_PACKETS,
                              seed=ONLINE_SEEDS["recovery"])
    rec = rec.slice(drift_index(rec))
    engine = PacketServeEngine(initial, feature_dim=len(traffic.COLUMNS),
                               max_batch=ONLINE_CHUNK, depth=2,
                               device=dev.type)
    probe = PacketServeEngine(initial, feature_dim=len(traffic.COLUMNS),
                              max_batch=ONLINE_CHUNK, depth=2,
                              device=dev.type, telemetry=False)
    detector = DriftDetector(snapshot, **ONLINE_DETECTOR)
    served = threading.Event()       # the drifting stream is served

    def retrain(windows):
        """The search, then a hold until the drifting stream is served:
        the example's gates (one episode, the install at the flush after
        the stream) assume a retrain that outlasts the stream, which a
        faster one would not; the held time is reported."""
        pipe = search_pipeline(windows_to_stream(windows, serve.flow_labels),
                               "retrain")
        t = time.perf_counter()
        served.wait(ONLINE_WAIT_S)
        info["retrain"]["held_s"] = time.perf_counter() - t
        return pipe

    ctrl = HotSwapController(engine, detector, retrain,
                             buffer_windows=ONLINE_BUFFER)
    seg = {k: ([], []) for k in ("before", "during", "held", "after")}
    verdicts, fired_at, t_fire = [], None, None
    for i, chunk in enumerate(serve.chunks(ONLINE_CHUNK)):
        ctrl.observe(chunk)
        if ctrl.episodes and fired_at is None:
            fired_at, t_fire = i, time.perf_counter()
        part = ("before" if fired_at is None else
                "during" if "retrain" not in info else "held")
        verdicts.append(serve_chunk(engine, chunk, *seg[part]))
    verdicts = np.concatenate(verdicts)
    served.set()
    probe_chunks = list(serve.chunks(ONLINE_CHUNK))
    k = 0
    while ctrl.retraining and time.perf_counter() - t_fire < ONLINE_WAIT_S:
        serve_chunk(probe, probe_chunks[k % len(probe_chunks)],
                    *seg["during"])
        k += 1
    check(ctrl.episodes == 1, f"path_online: {ctrl.episodes} drift "
          f"episodes, not 1 ({detector.report()})")
    check(ctrl.wait(ONLINE_WAIT_S), "path_online: the retrain did not "
          f"finish within {ONLINE_WAIT_S} s")
    retrain_s = time.perf_counter() - t_fire
    check(not ctrl.errors, f"path_online: retrain errors {ctrl.errors}")
    pre_state = (engine.state.keys.clone(), engine.state.regs.clone())
    swaps_before = engine.stats_.swaps
    engine.flush()
    check(engine.stats_.swaps == swaps_before + 1,
          "path_online: the swap did not install at the next flush")
    check(torch.equal(pre_state[0], engine.state.keys)
          and torch.equal(pre_state[1], engine.state.regs),
          "path_online: keys or registers changed across the install")
    rec_verdicts = np.concatenate([
        serve_chunk(engine, c, *seg["after"])
        for c in rec.chunks(ONLINE_CHUNK)])
    check(len(verdicts) == serve.n_packets
          and len(rec_verdicts) == rec.n_packets,
          "path_online: a verdict was dropped across the swap")
    launches = dict(_ext.LAUNCHES)
    stats = engine.stats()
    off = min(stats["swap_pkt_offsets"][0], serve.n_packets)
    # K1's verdicts, both models', and the tables against the plain twin
    keys, regs, plain = plain_online_twin(
        (pipes["phase-a"], pipes["retrain"]),
        np.concatenate([serve.packets, rec.packets]),
        stats["swap_pkt_offsets"][0])
    bad, near = verdict_mismatches(
        np.concatenate([verdicts, rec_verdicts]), plain)
    check(bad == 0, f"path_online: {bad} served verdicts differ from the "
          "plain twin's outside the 1e-4 margin")
    check(torch.equal(keys, engine.state.keys.cpu())
          and torch.equal(regs.view(torch.int32),
                          engine.state.regs.cpu().view(torch.int32)),
          "path_online: the served tables differ from the plain twin's")
    f1 = mlalgos.f1_score
    scores = {"pre_drift": f1(serve.labels[:ev_drift], verdicts[:ev_drift]),
              "post_drift": f1(serve.labels[ev_drift:off],
                               verdicts[ev_drift:off]),
              "post_swap": f1(rec.labels, rec_verdicts)}
    emit({"phase": "path_online", "packets": ONLINE_PACKETS,
          "chunk": ONLINE_CHUNK, "slots": ONLINE_SLOTS,
          "backend": engine.backend, "f1": scores,
          "drift_fired_at_window": fired_at,
          "drift_index": ev_drift, "models": info,
          "twin_within_margin": near,
          "retrain_wall_s": ctrl.report()["retrain_wall_s"],
          "fire_to_parked_s": retrain_s,
          "swap_lat_ms": stats["swap_lat_ms"],
          "swap_pkt_offsets": stats["swap_pkt_offsets"],
          "serving": {k: serving_row(*v) for k, v in seg.items()},
          "probe_batches": k, "controller": ctrl.report(),
          "journal": [e["kind"] for e in
                      engine.telemetry().journal.events()],
          "launches": launches, "nvidia_smi": nvidia_smi()})
    check(scores["pre_drift"] > ONLINE_F1["pre_drift"]
          and scores["post_drift"] < ONLINE_F1["post_drift"]
          and scores["post_swap"] > ONLINE_F1["post_swap"],
          f"path_online: F1 {scores} outside the example's gates "
          f"{ONLINE_F1}")
    return launches


def strategy_result(dev):
    """path_dag's seeded models "ad", "tc" and "ad_full" as a result the
    Table-3 accounting reads: each leaf's trained model (``dnn_model``,
    ``svm_model`` on the same weights) and its feasibility on Taurus 16 x
    16, beside the pipeline path_dag serves."""
    from types import SimpleNamespace

    from repro_torch.core import mlalgos
    from repro_torch.core.alchemy import Platforms
    from repro_torch.testing import AD_FULL_WIDTHS, AD_WIDTHS, he_mlp

    platform = Platforms.Taurus()
    platform.constrain(resources={"rows": 16, "cols": 16})
    pipes = dag_models(dev)[0]
    svm_w, svm_b = he_mlp((7, 2), 1)
    trained = {
        "ad": mlalgos.dnn_model(
            [{"w": w, "b": b} for w, b in zip(*he_mlp(AD_WIDTHS, 0))],
            list(AD_WIDTHS), 2, {}, device=dev),
        "tc": mlalgos.svm_model(svm_w[0], svm_b[0], {}),
        "ad_full": mlalgos.dnn_model(
            [{"w": w, "b": b} for w, b in zip(*he_mlp(AD_FULL_WIDTHS, 2))],
            list(AD_FULL_WIDTHS), 2, {}, device=dev)}
    return {name: SimpleNamespace(
                trained=tm, pipeline=pipes[name],
                report=platform.check(tm.algorithm, tm.topology))
            for name, tm in trained.items()}


def path_fusion(dev):
    """Paper Table 4 on the card at ``benchmarks/table4_fusion.py``'s
    configuration: ``make_ad_dataset(features=7, n_train=8192,
    n_test=4096)`` split in halves, two separate DNNs (``train_dnn``,
    hidden [24, 16], 10 epochs) and one fused model (``fusion.fuse``,
    the same), all trained on the card.  Gates: ``should_fuse``; the
    fused CU under 0.7 x the separate sum (``TaurusModel``); both tasks'
    F1 > 0.6 and within 0.1 of each other (``tests/test_alchemy_dse.py:
    176-179``); each task's ``task_pipeline`` served through
    ``PacketServeEngine`` at B = 1,024 on K3, its verdicts equal to
    ``FusedModel.predict`` under the margin rule (1e-4).  Then Table 3:
    ``strategy_table`` over path_dag's ``ad > tc``, ``ad | tc``, ``ad >
    (tc | ad)`` and ``ad_full > tc``, the repeated model counted once
    (its row equals ``ad > tc``'s) and ``ad > tc`` the sum of its two
    models.  -> launches."""
    import numpy as np

    from repro_torch.core import chaining, fusion, mlalgos
    from repro_torch.core.alchemy import Model
    from repro_torch.core.feasibility import TaurusModel
    from repro_torch.data import netdata
    from repro_torch.kernels import _ext
    from repro_torch.serve import PacketServeEngine

    d = netdata.make_ad_dataset(**FUSION_DATA)
    parts = d.split_half()
    tm = TaurusModel()
    want_backend = "cuda" if dev.type == "cuda" else "cpu-ref"
    _ext.reset_launches()
    rows = []
    for name, part in zip(("AD: Part 1", "AD: Part 2"), parts):
        t = time.perf_counter()
        m = mlalgos.train_dnn(part, hidden=FUSION_HIDDEN,
                              epochs=FUSION_EPOCHS, seed=0, device=dev.type)
        est = tm.estimate("dnn", m.topology)["options"][0]
        rows.append({"model": name, "pcu": est["cu"], "pmu": est["mu"],
                     "f1": mlalgos.f1_score(part.test_y,
                                            m.predict(part.test_x)),
                     "train_s": time.perf_counter() - t})
    check(fusion.should_fuse(*parts), "path_fusion: the halves should fuse")
    t = time.perf_counter()
    fused = fusion.fuse(list(parts), hidden=FUSION_HIDDEN,
                        epochs=FUSION_EPOCHS, device=dev.type)
    fuse_s = time.perf_counter() - t
    est = tm.estimate("dnn", fused.fused_topology())["options"][0]
    f1s = [fused.f1(0), fused.f1(1)]
    rows.append({"model": "AD: Fused", "pcu": est["cu"], "pmu": est["mu"],
                 "f1": f1s, "train_s": fuse_s})
    sum_cu = rows[0]["pcu"] + rows[1]["pcu"]
    served = []
    for task in (0, 1):
        pipe = fused.task_pipeline(task)
        check(pipe.compiled_backend == want_backend,
              f"path_fusion: task {task} serves on {pipe.compiled_backend}")
        X = fused.datasets[task].test_x
        eng = PacketServeEngine(pipe, feature_dim=X.shape[1],
                                max_batch=FUSION_BATCH, depth=2,
                                device=dev.type)
        v = np.concatenate(list(eng.serve_stream(
            X[i:i + FUSION_BATCH] for i in range(0, len(X), FUSION_BATCH))))
        top = np.sort(fused.logits(task, X).astype(np.float64), 1)
        near = top[:, -1] - top[:, -2] <= 1e-4
        differ = v != fused.predict(task, X)
        check(len(v) == len(X) and not (differ & ~near).any(),
              f"path_fusion: task {task}'s K3 verdicts differ from "
              "FusedModel.predict outside the 1e-4 margin")
        served.append(dict(row_of(eng), task=task,
                           within_margin=int((differ & near).sum())))
    launches = dict(_ext.LAUNCHES)
    result = strategy_result(dev)
    ad, tc, full = (Model(n) for n in ("ad", "tc", "ad_full"))
    strategies = {"ad > tc": ad > tc, "ad | tc": ad | tc,
                  "ad > (tc | ad)": ad > (tc | ad),
                  "ad_full > tc": full > tc}
    table = chaining.strategy_table(strategies, result)
    summary = {k: chaining.dag_stage_summary(n, result)["params"]
               for k, n in strategies.items()}
    by = {r["strategy"]: r for r in table}
    emit({"phase": "path_fusion", "data": FUSION_DATA,
          "hidden": FUSION_HIDDEN, "epochs": FUSION_EPOCHS, "table4": rows,
          "fused_cu_over_separate": est["cu"] / sum_cu, "served": served,
          "table3": table, "table3_params": summary,
          "launches": launches, "nvidia_smi": nvidia_smi()})
    check(est["cu"] < 0.7 * sum_cu, f"path_fusion: fused CU {est['cu']} "
          f"not under 0.7 x {sum_cu}")
    check(min(f1s) > 0.6 and abs(f1s[0] - f1s[1]) < 0.1,
          f"path_fusion: fused F1 {f1s}")
    check({k: v for k, v in by["ad > (tc | ad)"].items() if k != "strategy"}
          == {k: v for k, v in by["ad > tc"].items() if k != "strategy"},
          "path_fusion: the repeated model was counted twice")
    check(by["ad > tc"]["cu"] == result["ad"].report.resources["cu"]
          + result["tc"].report.resources["cu"],
          "path_fusion: ad > tc is not the sum of its models")
    check(summary["ad > (tc | ad)"] == summary["ad > tc"]
          == result["ad"].trained.param_count
          + result["tc"].trained.param_count,
          f"path_fusion: Table-3 params {summary}")
    return launches


# --------------------------------- slice 14: sharded packet serving

SHARD_COUNTS = (1, 2, 4)
SHARD_B = 512                       # max_batch: the sub-batch is B / n
SHARD_AD_B = 1024                   # the stateless split of ad > tc


def shard_devices(dev, n: int) -> list:
    """The one card listed n times: n shards, each with its own table."""
    return [str(dev)] * n


def shard_ids(stages, X, n: int):
    """Each packet's shard: its flow key (``FlowKey.apply_keys_np``) then
    ``shard_of_key``, as the engine routes it."""
    from repro_torch.serve.sharded import shard_of_key

    return shard_of_key(stages[0].apply_keys_np(X), n)


def route_pushbacks(ids, n: int, batch: int) -> int:
    """The rows the routing pushes back to the queue head when every
    packet is queued at once and each dispatch takes up to ``batch``
    rows, replayed on the host with ``route_prefix``."""
    from repro_torch.serve.sharded import route_prefix

    pushed = pos = 0
    while pos < len(ids):
        take = ids[pos:pos + batch]
        m, _ = route_prefix(take, n, batch // n)
        pushed += len(take) - m
        pos += m
    return pushed


def metric_value(eng, name: str) -> float:
    return eng.telemetry().snapshot()[name]["values"][0]["value"]


def shard_references(dev, stages, X, ids, n: int, mlp: bool) -> dict:
    """Per shard s, the rows ``X[ids == s]`` in arrival order through
    single-device engines: ``backend="cuda"`` fused and split, and the
    plain walk (``plain_stream``, with its logits, for an MLP suffix;
    else a ``backend="interpret"`` engine).  -> {"cuda": {fuse: [(verdicts,
    tables)]}, "plain": [(verdicts or logits, tables)]}."""
    import numpy as np

    from repro_torch.testing import plain_stream

    b = SHARD_B // n
    out = {"cuda": {True: [], False: []}, "plain": []}
    for s in range(n):
        rows = X[ids == s]
        chunks = [rows[i:i + b] for i in range(0, len(rows), b)]
        for fuse in (True, False):
            eng = serve_engine(stages, "cuda", fuse, b, dev)
            v = np.concatenate(list(eng.serve_stream(chunks))) \
                if len(rows) else np.zeros((0,), np.int32)
            out["cuda"][fuse].append((v, state_arrays(eng.state)))
        if mlp:
            keys, regs, logits = plain_stream(stages, rows, b, dev)
            out["plain"].append((logits, [keys, regs.view(np.int32)]))
        else:
            eng = serve_engine(stages, "interpret", True, b, dev)
            v = np.concatenate(list(eng.serve_stream(chunks)))
            out["plain"].append((v, state_arrays(eng.state)))
    return out


def sharded_run(dev, name: str, stages, fuse: bool, n: int, stream, ids,
                refs, mlp: bool) -> dict:
    """One configuration at n shards: a ``ShardedPacketServeEngine``
    serving the whole stream with every dispatch under
    ``set_sync_debug_mode("error")`` (``sync_checked_serve``), its tables
    and verdicts held to the per-shard references (gates 1-5 of
    ``path_sharded``), then a timed ``serve_stream`` pass in chunks of B
    whose verdicts must equal the first's.  -> the phase row."""
    import numpy as np

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.serve import ShardedPacketServeEngine
    from repro_torch.testing import verdict_mismatches

    def engine():
        return ShardedPacketServeEngine(
            StatefulPipeline(stages, backend="cuda", fuse=fuse,
                             device=dev.type),
            feature_dim=len(traffic.COLUMNS), max_batch=SHARD_B, depth=2,
            devices=shard_devices(dev, n), min_shards=1)

    tag = f"{name} fuse={fuse} n={n}"
    X = stream.packets
    eng = engine()
    check(eng.sharded and eng.stats()["shards"] == n,
          f"{tag}: stats {eng.stats()['shards']} shards")
    v = sync_checked_serve(eng, X, SHARD_B)
    check(len(v) == len(X), f"{tag}: {len(v)} verdicts for {len(X)}")
    margin_rows = 0
    for s, table in enumerate(eng.state.tables):
        got = state_arrays(table)
        want_v, want_t = refs["cuda"][fuse][s]
        check(np.array_equal(v[ids == s], want_v) and all(
            np.array_equal(a, b) for a, b in zip(got, want_t)),
            f"{tag}: shard {s} differs from its single-device engine")
        plain_v, plain_t = refs["plain"][s]
        check(all(np.array_equal(a, b) for a, b in zip(got, plain_t)),
              f"{tag}: shard {s}'s tables differ from the plain walk")
        if mlp:
            bad, close = verdict_mismatches(v[ids == s], plain_v)
            check(bad == 0, f"{tag}: shard {s}: {bad} verdicts outside "
                  "the margin of the plain walk")
            margin_rows += close
        else:
            check(np.array_equal(v[ids == s], plain_v),
                  f"{tag}: shard {s}'s verdicts differ from interpret")
    pushed = route_pushbacks(ids, n, SHARD_B)
    overflow = metric_value(eng, "serve_route_overflow_total")
    check(overflow == pushed, f"{tag}: overflow counter {overflow}, the "
          f"host replay pushes back {pushed}")
    batches = eng.stats()["batches"]
    timed = engine()
    tv = np.concatenate(list(timed.serve_stream(stream.chunks(SHARD_B))))
    check(np.array_equal(tv, v), f"{tag}: the streamed pass differs")
    st = timed.stats()
    return {"config": name, "fuse": fuse, "shards": n,
            "sub_batch": SHARD_B // n, "backend": st["backend"],
            "pkt_per_s": st["pkt_per_s"], "lat_p50_ms": st["lat_p50_ms"],
            "lat_p99_ms": st["lat_p99_ms"], "dispatch_s": st["dispatch_s"],
            "wall_s": st["wall_s"], "batches": st["batches"],
            "pad_packets": st["pad_packets"], "pushed_back": pushed,
            "overflow_counter": overflow, "margin_rows": margin_rows,
            "mitigated": st["mitigated"],
            "launch_batches": batches + st["batches"]}


def sharded_swap(dev, stream, n: int) -> dict:
    """Gate 6: mitigate-fused, fused, n shards; half the stream, then a
    hot swap to the same pipeline at twice the slots, installed at the
    flush: each shard's detection table must equal ``migrate_state`` of
    its pre-swap table and its action table (same spec) carry bit for
    bit; then the rest of the stream; every verdict returned, one swap."""
    import numpy as np
    import torch

    from repro_torch.data import traffic
    from repro_torch.flowstate import FlowState, StatefulPipeline
    from repro_torch.flowstate.registers import migrate_state
    from repro_torch.serve import ShardedPacketServeEngine

    X = stream.packets
    half = len(X) // 2
    eng = ShardedPacketServeEngine(
        StatefulPipeline(mat_fused_stages(S_KERNEL, True), backend="cuda",
                         device=dev.type),
        feature_dim=len(traffic.COLUMNS), max_batch=SHARD_B, depth=2,
        devices=shard_devices(dev, n), min_shards=1)
    eng.submit(X[:half])
    first = eng.flush()
    before = [(t.spec, t.keys.clone(), t.regs.clone(), state_arrays(t)[2:])
              for t in eng.state.tables]
    new = mat_fused_stages(2 * S_KERNEL, True)
    eng.swap(StatefulPipeline(new, backend="cuda", device=dev.type))
    eng.flush()                            # the boundary installs it
    check(eng.stats()["swaps"] == 1 and not eng.swap_pending,
          f"sharded swap: {eng.stats()['swaps']} swaps installed")
    for s, (t, (spec, k, r, mit)) in enumerate(zip(eng.state.tables,
                                                    before)):
        want = migrate_state(FlowState(spec, k, r), new[1].spec)
        got = state_arrays(t)
        check(t.spec == new[1].spec and np.array_equal(
            got[0], want.keys.cpu().numpy()) and np.array_equal(
            got[1], want.regs.cpu().numpy().view(np.int32)),
            f"sharded swap: shard {s}'s table is not migrate_state's")
        check(all(np.array_equal(a, b) for a, b in zip(got[2:], mit)),
              f"sharded swap: shard {s}'s action table did not carry")
    eng.submit(X[half:])
    rest = eng.flush()
    torch.cuda.synchronize()
    check(len(first) + len(rest) == len(X) and eng.stats()["swaps"] == 1,
          f"sharded swap: {len(first) + len(rest)} verdicts for {len(X)}")
    st = eng.stats()
    return {"config": "mitigate-fused", "shards": n,
            "slots": [S_KERNEL, 2 * S_KERNEL], "swaps": st["swaps"],
            "swap_lat_ms": st["swap_lat_ms"],
            "swap_pkt_offsets": st["swap_pkt_offsets"],
            "verdicts": len(first) + len(rest),
            # n a batch, one warm-up each for the engine and the swap
            "launches_expected": n * st["batches"] + 2}


def sharded_stateless(dev, n: int) -> dict:
    """Gate 7: ``ad > tc`` fused (K6) over n shards of B = 1,024, each
    shard its contiguous quarter of every batch, dispatched under
    ``set_sync_debug_mode("error")``: row for row the single-device
    engine's verdicts."""
    import numpy as np
    import torch

    from repro_torch.core import chaining
    from repro_torch.serve import ShardedPacketServeEngine
    from repro_torch.serve.packet_engine import PacketServeEngine

    X = ad_test_set()
    dag = chaining.compile_dag(dag_nodes()["ad>tc"], dag_models(dev)[0],
                               backend="cuda", device=dev.type)
    single = PacketServeEngine(dag, feature_dim=AD_FEATURES,
                               max_batch=SHARD_AD_B, depth=2,
                               device=dev.type)
    single.submit(X)
    want = single.flush()
    eng = ShardedPacketServeEngine(dag, feature_dim=AD_FEATURES,
                                   max_batch=SHARD_AD_B, depth=2,
                                   devices=shard_devices(dev, n),
                                   min_shards=1)
    eng.submit(X)
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.pending:
            while eng.pending and eng.in_flight < eng.depth:
                eng._dispatch_batch(eng._take(min(SHARD_AD_B, eng.pending)))
            torch.cuda.set_sync_debug_mode(0)
            while eng.in_flight:
                got.append(eng._fetch_one())
            torch.cuda.set_sync_debug_mode("error")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = np.concatenate(got)
    check(np.array_equal(got, want),
          f"ad>tc over {n} shards differs from the single-device engine "
          f"on {int((got != want).sum())} rows")
    st = eng.stats()
    check(st["shards"] == n and st["backend"].endswith("fused-dag"),
          f"ad>tc sharded stats {st['shards']} {st['backend']}")
    return {"config": "ad>tc", "shards": n, "max_batch": SHARD_AD_B,
            "rows": len(X), "backend": st["backend"],
            "pkt_per_s": st["pkt_per_s"], "lat_p50_ms": st["lat_p50_ms"],
            "lat_p99_ms": st["lat_p99_ms"], "batches": st["batches"],
            # n a batch; the single-device engine's one; a warm-up each
            "launches_expected": n * st["batches"]
            + single.stats()["batches"] + 2}


def path_sharded(dev):
    """Sharded packet serving (``ShardedPacketServeEngine``) on the one
    card listed 1, 2 and 4 times (each entry a shard with its own table):
    flow-ddos (K1, or K2 + K3) and mitigate-fused (K1, or K2 + K4 with
    the graphed action table) on 16,000 ddos_burst packets (seed 1), B =
    512, depth 2.  Gates, per configuration, fuse and n: (1) each shard's
    tables and verdicts bit for bit those of a single-device
    ``PacketServeEngine(backend="cuda")`` fed that shard's rows
    (``shard_of_key`` of the flow key) in arrival order; (2) the tables
    bit for bit the plain walk's of those rows, MAT and mitigated
    verdicts exact against ``backend="interpret"``, MLP verdicts under
    the margin rule; (3) ``serve_route_overflow_total`` equal to the
    push-backs ``route_prefix`` gives replayed on the host; (4)
    ``stats()["shards"] == n``; (5) every dispatch silent under
    ``set_sync_debug_mode("error")``; then (6) a mid-stream swap to
    twice the slots at n = 4 (``sharded_swap``) and (7) ``ad > tc`` on
    K6 over 4 shards (``sharded_stateless``).  Launches held to n per
    batch plus one warm-up per engine.  Also: the default engine
    (``devices`` every visible card, ``min_shards=2``) on a one-card
    machine degrades with ``shards == 1``, and ``backend="cuda"`` on a
    pipeline K1 cannot take raises its decline reason.  pkt/s and p50 /
    p99 per n are reported, not gated: n shards on one card cost n
    times the launches of a batch.  -> launches per kernel."""
    import torch

    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.kernels import _ext
    from repro_torch.serve import ShardedPacketServeEngine

    t0 = time.perf_counter()
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                 seed=STREAM_SEED)
    X = stream.packets
    configs = {"flow-ddos": (flow_ddos_stages(S_KERNEL), True,
                             ("fused_mlp_classify",)),
               "mitigate-fused": (mat_fused_stages(S_KERNEL, True), False,
                                  ("mat_lut_classify",))}
    rows, launches = [], dict.fromkeys(_ext.LAUNCHES, 0)
    for name, (stages, mlp, classify) in configs.items():
        for n in SHARD_COUNTS:
            ids = shard_ids(stages, X, n)
            refs = shard_references(dev, stages, X, ids, n, mlp)
            for fuse in (True, False):
                _ext.reset_launches()
                row = sharded_run(dev, name, stages, fuse, n, stream, ids,
                                  refs, mlp)
                torch.cuda.synchronize()
                got = dict(_ext.LAUNCHES)
                k = n * row.pop("launch_batches") + 2   # + two warm-ups
                want = dict.fromkeys(got, 0) | (
                    {"fused_flow_serve": k} if fuse else
                    {"flow_update": k, **dict.fromkeys(classify, k)})
                check(got == want, f"{name} fuse={fuse} n={n}: launches "
                      f"{got} != {want}")
                row["launches"] = {a: b for a, b in got.items() if b}
                for a, b in got.items():
                    launches[a] += b
                rows.append(row)
    for kernel, run in (("fused_flow_serve", lambda: sharded_swap(
            dev, stream, 4)), ("fused_dag", lambda: sharded_stateless(dev, 4))):
        _ext.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = dict(_ext.LAUNCHES)
        want = dict.fromkeys(got, 0) | {
            kernel: out.pop("launches_expected")}
        check(got == want, f"{out['config']} sharded launches {got} != "
              f"{want}")
        for a, b in got.items():
            launches[a] += b
        if kernel == "fused_dag":
            stateless = out
        else:
            swap = out
    # the default engine (every visible card, min_shards=2), and no
    # fallback
    cards = torch.cuda.device_count()
    default = {"cards": cards}
    if dev.type == "cuda":
        eng = ShardedPacketServeEngine(
            StatefulPipeline(flow_ddos_stages(S_KERNEL), backend="cuda",
                             device=dev.type),
            feature_dim=len(traffic.COLUMNS), max_batch=SHARD_B)
        default.update(sharded=eng.sharded, shards=eng.stats()["shards"])
        check(eng.sharded == (cards >= 2) and default["shards"] == (
            cards if cards >= 2 else 1),
            f"default engine on {cards} cards: {default['shards']} shards")
    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=S_KERNEL)
    try:
        ShardedPacketServeEngine(
            StatefulPipeline([fk, ru, ws], device=dev.type),
            feature_dim=len(traffic.COLUMNS), max_batch=SHARD_B,
            backend="cuda", devices=shard_devices(dev, 2), min_shards=1)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "cannot serve" in refused,
          f"backend='cuda' on a features-only pipeline: {refused}")
    emit({"phase": "path_sharded", "n_packets": len(X), "max_batch": SHARD_B,
          "depth": 2, "rows": rows, "swap": swap, "stateless": stateless,
          "default_engine": default,
          "no_fallback": refused, "launches": {
              a: b for a, b in launches.items() if b},
          "sync_debug": "error, no raise",
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    return launches


# --------------------------- slice 14: the MoE family (Moonshot, K7)

MOE_ARCH, MOE_SEED, MOE_F32_LAYERS = "moonshot-v1-16b-a3b", 0, 8
# round 1: four 512-token prompts; round 2: four of 17-32 tokens (left-
# padded to 32); 32 new tokens each.  Every prefill takes the MoE
# grouping (B * S <= 256 or a multiple of 256), and so does round 2's
# teacher-forced forward over 32 + 32 positions
MOE_ROUNDS = ((512, 512, 32), (17, 32, 32))


# the f32 run's routing rule: where the two attention engines' prefills
# first choose different experts for a token, the plain run's gap between
# that token's k-th and (k+1)-th expert probabilities must be within this
# (the engines part only at a near-tie, as rounding can make them)
ROUTE_MARGIN = 1e-4


def moe_requests(vocab: int):
    return hybrid_requests(vocab, MOE_ROUNDS)


def layer_trace(params, cfg, toks, backend: str, dev,
                max_seq: int = LM_MAX_SEQ, memory=None) -> dict:
    """A prefill of toks (over ``memory``) on one attention engine
    (``"cuda"``: K7; ``"interpret"``: the plain attention) -> {"inputs":
    each layer's residual-stream input (an encdec's encoder layers
    first), "layers": each layer's (slot, parameters), "cross": each
    cross-attention's (parameters, residual-stream input, memory),
    "moe_inputs": each MoE FFN's normed input, "routes": each MoE FFN's
    (top-k expert ids [T, k], probabilities [T, E]), "logits": the last
    position's logits, f32}."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve.steps import init_cache

    out = {"inputs": [], "layers": [], "cross": [], "moe_inputs": [],
           "routes": []}
    real_slot, real_apply, real_route, real_cross = \
        tf._apply_slot, moe.moe_apply, moe.route, tf._cross

    def slot(p, s, x, *a, **kw):
        out["inputs"].append(x)
        out["layers"].append((s, p))
        return real_slot(p, s, x, *a, **kw)

    def cross(p, x, *a, **kw):
        out["cross"].append((p, x, kw["memory"]))
        return real_cross(p, x, *a, **kw)

    def apply(p, x, *a, **kw):
        out["moe_inputs"].append(x)
        return real_apply(p, x, *a, **kw)

    def route(*a, **kw):
        r = real_route(*a, **kw)
        out["routes"].append((r["experts"].flatten(0, -2),
                              r["probs"].flatten(0, -2)))
        return r

    tf._apply_slot, tf.moe_mod.moe_apply, moe.route, tf._cross = \
        slot, apply, route, cross
    try:
        cache = init_cache(cfg, toks.shape[0], max_seq, device=dev)
        with torch.no_grad():
            out["logits"] = tf.forward(
                params, cfg, tokens=torch.as_tensor(toks, device=dev),
                mode="prefill", caches=cache, logits_slice_last=True,
                backend=backend, memory_embeds=memory)[0][:, -1].float()
    finally:
        tf._apply_slot, tf.moe_mod.moe_apply, moe.route, tf._cross = \
            real_slot, real_apply, real_route, real_cross
    return out


def routing_divergence(a: dict, b: dict, k: int) -> dict:
    """Trace a against trace b (the plain run), layer by layer: the
    largest difference of the layer's input against its largest
    magnitude, the tokens whose top-k expert set differs, and the
    smallest gaps (k-th against (k+1)-th probability, in b) among them;
    the first layer where a set differs, and the logits' difference."""
    import torch

    layers, first = [], None
    for i, ((xa, (ea, _)), (xb, (eb, pb))) in enumerate(zip(
            zip(a["inputs"], a["routes"]), zip(b["inputs"], b["routes"]))):
        flip = (torch.sort(ea, -1).values != torch.sort(eb, -1).values
                ).any(-1)
        top = torch.sort(pb, -1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        n = int(flip.sum())
        if n and first is None:
            first = i
        layers.append({
            "input_rel_diff": float((xa.float() - xb.float()).abs().max()
                                    / xb.float().abs().max()),
            "flipped_tokens": n,
            "flip_gaps": sorted(float(g) for g in gap[flip])[:8],
            "max_flip_gap": float(gap[flip].max()) if n else None,
            "median_gap": float(gap.median())})
    return {"layers": layers, "first_flip_layer": first,
            "first_flip_max_gap": (layers[first]["max_flip_gap"]
                                   if first is not None else None),
            "logit_err": float((a["logits"] - b["logits"]).abs().max())}


def path_moe_serve(dev):
    """``ServeEngine`` with Moonshot-v1-16B-A3B (every layer attention on
    K7 and an MoE FFN: d_model 2,048, 16 heads of 128, 64 experts top-6
    of d_ff 1,408, vocab 163,840), weights from ``torch.Generator`` seed
    0 on the card, batch_slots 4, max_seq 1,024, the 8 requests of
    ``MOE_ROUNDS`` in one ``run`` per engine, ``backend="cuda"`` against
    ``"interpret"``; K7 must launch num_layers x (prefill + decode calls)
    times and nothing else.  The earlier LM phases' weights are freed
    first.  Twice:

    * bf16, full depth (48 layers, 56.1 GB): per-block gates on the
      path's own input (round 1's prompts embedded and normed), as
      ``path_hybrid_serve``'s bf16 run has them: layer 0's attention on
      K7 (prefill and one decode step) and layer 0's MoE FFN against a
      plain per-expert gather, each within 8e-3 of max(1, |plain|).
      Logits, tokens, teacher forcing, tok/s, prefill ms and decode ms
      reported.
    * f32, 8 of the 48 layers (about 21 GB).  Each of the 8 layers'
      blocks on the plain run's own inputs (round 1's prefill traced on
      ``interpret``): its attention on K7 (prefill and a decode step)
      and its MoE FFN against the per-expert gather, within 1e-5 of the
      block output's scale.  Each round's prefill traced on both
      engines: where no token's experts differ, the logits within
      ``LM_LOGIT_TOL``; where they do, the first layer that differs
      must differ only at near-ties (``ROUTE_MARGIN``).  At this width
      and seed the plain path's own logits move O(1) under a change of
      its attention's summation order alone (``tools/moe_probe.py``: 64
      experts top-6 over 8 layers amplify f32 rounding to a routing flip
      by layer 2, and the flips cascade), so no implementation holds
      the dense family's end-to-end gates: the logits against
      ``interpret``, the first differing tokens with their margins, and
      decode against teacher forcing on a drop-free rerun
      (``capacity_factor`` = E / k), on K7 and on the plain path alone,
      are reported.

    -> the bf16 run's launches per kernel."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.registry import init_params
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    full = configs.get_config(MOE_ARCH)
    n_new = sum(new for _, _, new in MOE_ROUNDS)
    report, gates = {}, []
    for dtype, layers in ((torch.bfloat16, full.num_layers),
                          (torch.float32, MOE_F32_LAYERS)):
        cfg = dataclasses.replace(full, num_layers=layers)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = init_params(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(MOE_SEED), device=dev, dtype=dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        runs = serve_both(cfg, params, moe_requests, n_new, dev)
        cuda, plain = runs["cuda"], runs["interpret"]
        check_serve_runs("path_moe_serve", cfg, runs, LM_SLOTS, n_new)
        rep = dict(num_layers=layers, weights_gb=sum(
            x.numel() * x.element_size() for x in _leaves(params)) / 1e9,
            init_s=init_s, **run_fields(runs))
        batches = lm_batches(cuda["reqs"])
        errs, drops = [], {}
        for i, (S, toks, _) in enumerate(batches):
            lg, aux = prefill_logits(params, cfg, toks[:, :S], "cuda",
                                     None, dev)
            plg, _ = prefill_logits(params, cfg, toks[:, :S], "interpret",
                                    None, dev)
            check(bool(torch.isfinite(lg).all()), "non-finite logits")
            errs.append(max_abs(lg, plg))
            drops[f"prefill_round_{i + 1}"] = float(aux["moe_drop_frac"])
        rep["prefill_logit_err"] = errs
        diffs = first_diffs(params, cfg, cuda["reqs"], plain["reqs"], None,
                            dev)
        rep["requests_differing"], rep["first_diffs"] = len(diffs), diffs
        published = teacher_forcing(params, cfg, cuda["reqs"][LM_SLOTS:],
                                    None, dev)
        rep["published_capacity"] = {
            "capacity_factor": cfg.capacity_factor,
            "teacher_forcing_agree": float(np.mean(published["agree"])),
            "teacher_forcing_miss_margins": [
                m["margin"] for m in published["misses"]],
            "moe_drop_frac_sum": dict(
                drops, teacher_forcing=published["drop_frac_sum"])}
        if dtype == torch.bfloat16:
            main_launches = cuda["launches"]
            S, toks, _ = batches[0]
            toks = toks[:, :S + 1]
            rep["block_err"] = {
                "attention": self_block_check(
                    params["layers"][0]["attn"],
                    block_input(params, cfg, 0, "ln1", toks, dev), cfg, dev,
                    "layer 0 attention"),
                "moe": moe_block_check(params, cfg, toks, None, dev)}
        else:
            rep["routing"], rep["block_err"] = [], []
            for i, (S, toks, _) in enumerate(batches):
                traces = {b: layer_trace(params, cfg, toks[:, :S], b, dev)
                          for b in ("cuda", "interpret")}
                div = routing_divergence(traces["cuda"],
                                         traces["interpret"],
                                         cfg.num_experts_per_tok)
                rep["routing"].append(div)
                if i == 0:
                    # every layer's blocks on the plain run's own inputs
                    plain = traces["interpret"]
                    for layer in range(cfg.num_layers):
                        h = rmsnorm(params["layers"][layer]["ln1"],
                                    plain["inputs"][layer], cfg.norm_eps)
                        rep["block_err"].append({
                            "layer": layer,
                            "attention": self_block_check(
                                params["layers"][layer]["attn"], h, cfg,
                                dev, f"layer {layer} attention"),
                            "moe": moe_block_check(
                                params, cfg, None, None, dev, layer=layer,
                                x=plain["moe_inputs"][layer])})
                del traces
                first, gap = div["first_flip_layer"], \
                    div["first_flip_max_gap"]
                gates.append((
                    div["logit_err"] <= LM_LOGIT_TOL if first is None
                    else gap <= ROUTE_MARGIN,
                    f"f32 round {i + 1}: logits differ by "
                    f"{div['logit_err']}, routing first differs at layer "
                    f"{first} with a gap of {gap} > {ROUTE_MARGIN}"))
            # decode against teacher forcing, drop-free, on each engine
            # alone: reported (see the docstring)
            free = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts
                / cfg.num_experts_per_tok)
            rep["teacher_forcing"] = {"capacity_factor":
                                      free.capacity_factor}
            for backend in ("cuda", "interpret"):
                eng = ServeEngine(free, params, batch_slots=LM_SLOTS,
                                  max_seq=LM_MAX_SEQ, backend=backend,
                                  device=dev)
                free_reqs = moe_requests(cfg.vocab_size)[LM_SLOTS:]
                for r in free_reqs:
                    eng.submit(r)
                eng.run(max_steps=MOE_ROUNDS[1][2])
                del eng
                tf = teacher_forcing(params, free, free_reqs, None, dev,
                                     backend)
                rep["teacher_forcing"][backend] = {
                    "agree": float(np.mean(tf["agree"])),
                    "agree_by_request": tf["agree"],
                    "miss_margins": [m["margin"] for m in tf["misses"]],
                    "moe_drop_frac_sum": tf["drop_frac_sum"]}
        # serve_both resets the peak before each run: the cuda run's, then
        # everything since the interpret run began
        rep["phase_peak_gb"] = max(
            cuda["peak_gb"], torch.cuda.max_memory_allocated(dev) / 1e9)
        report["bf16" if dtype == torch.bfloat16 else "f32"] = rep
        del params, runs, cuda, plain
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "path_moe_serve", "arch": MOE_ARCH,
          "params": full.param_count(), "batch_slots": LM_SLOTS,
          "max_seq": LM_MAX_SEQ, "held_gb_before": held_gb,
          "prompt_lens": [len(r.prompt) for r in moe_requests(
              full.vocab_size)],
          "max_new_tokens": [new for _, _, new in MOE_ROUNDS],
          "logit_tol": LM_LOGIT_TOL, **report,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return main_launches


# ----------- slice 15: Mixtral's window and ring, vision and encdec cross-
# attention (K7), xLSTM

MX_ARCH, MX_SEED = "mixtral-8x7b", 0
# this card's share of the 8 experts (ep = 2): 24.15 B parameters, 48.3
# GB in bf16 (all 8 would be 93.4 GB)
MX_EXPERTS = range(0, 4)
MX_F32_LAYERS = 4                 # f32 with all 8 experts: about 24 GB
MX_SLOTS, MX_MAX_SEQ = 2, 4352    # the cache holds T = min(4,352, 4,096)
# round 1: two 4,096-token prompts and 128 new tokens (the decode wraps
# the ring: slots 0-127 take positions 4,096-4,223); round 2: two of
# 17-32 tokens (left-padded to 32), 32 new.  Prefills of 8,192 and 64
# tokens and teacher-forced forwards of 8,448 and 128 take the MoE
# grouping (a multiple of 256, or at most 256)
MX_ROUNDS = ((4096, 4096, 128), (17, 32, 32))
# the block gates' input: round 1's 4,224 tokens and 128 seeded ones, a
# 4,350-token windowed prefill (the window binds) then 2 ring decode
# steps (8,704 tokens for the MoE block: 34 groups of 256)
MX_BLOCK_S, MX_RING_STEPS = 4352, 2
VL_ARCH, ED_ARCH, XL_ARCH, LM15_SEED = (
    "llama-3.2-vision-11b", "seamless-m4t-large-v2", "xlstm-1.3b", 0)
# xLSTM: round 1 four 512-token prompts and 128 new tokens, round 2 four
# of 17-32 and 32 new; every prefill and teacher-forced forward (512,
# 640, 32, 64 positions) keeps the mLSTM's chunk rule, S % min(128, S)
XL_ROUNDS = ((512, 512, 128), (17, 32, 32))
# xLSTM's depth on the card: 24 of its 48 blocks (three 8-block periods,
# an sLSTM leading each), cut to keep the whole smoke inside its time
# budget once path_launch runs (the phase took 90.4 s at 48 blocks, an
# H100 80GB HBM3 at 700 W); its blocks are plain PyTorch, no kernel
XL_LAYERS = 24
# memory embeddings (image patches, audio frames) as the reference's
# batch defs draw them: normal, std 0.02
MEM_STD = 0.02
MEM_KEY = {"vlm": "image_embeds", "encdec": "frames"}
# which of the dense family's end-to-end gates each path's f32 run holds
# (``end_to_end``); the rest are reported.  With seeded weights the
# reference's init gives attention scores with a spread of about 100 at
# these widths (no QK-norm), so near-ties decide which key a query takes
# and each layer amplifies a rounding difference: the plain attention
# alone moves the logits by O(1) when only its summation order changes
# (``plain_reorder_logit_err``) over Llama-3.2-Vision's 40 layers and
# SeamlessM4T's 24, and the bf16 KV cache's rounding does the same to
# decode against teacher forcing on both engines, Mixtral's 4 layers
# included (``teacher_forcing_plain``).  Mixtral's 4 layers keep K7's
# tokens within the margin of the plain path's; its logits are held by
# the routing rule.  Every path gates its attention blocks instead.
E2E_GATED = {MX_ARCH: ("tokens",), VL_ARCH: (), ED_ARCH: ()}


def mixtral_requests(vocab: int):
    return hybrid_requests(vocab, MX_ROUNDS, MX_SLOTS)


def xlstm_requests(vocab: int):
    return hybrid_requests(vocab, XL_ROUNDS)


def k7_per_run(cfg, prefill_calls: int, decode_calls: int) -> int:
    """K7 calls of a serving run: one per attention and per cross-
    attention layer a call, and an encdec's encoder layers once a
    prefill."""
    from repro_torch.models.transformer import decoder_layout, encoder_layout

    n_p, slots = decoder_layout(cfg)
    per_call = n_p * sum((s.mixer == "attn") + s.cross for s in slots)
    enc = encoder_layout(cfg)[0] if cfg.family == "encdec" else 0
    return per_call * (prefill_calls + decode_calls) + enc * prefill_calls


def check_serve_runs(name, cfg, runs, slots: int, n_new: int) -> dict:
    """K7 launched ``k7_per_run`` times on ``backend="cuda"`` and nothing
    else, nothing on ``"interpret"``, every request served its tokens
    -> the cuda run's launches."""
    from repro_torch.kernels import _ext

    cuda, plain = runs["cuda"], runs["interpret"]
    want = dict.fromkeys(_ext.LAUNCHES, 0) | {"flash_attention": k7_per_run(
        cfg, cuda["calls"]["prefill_calls"], cuda["calls"]["decode_calls"])}
    check(cuda["launches"] == want,
          f"{name} launched {cuda['launches']}, not {want}")
    check(sum(plain["launches"].values()) == 0,
          f"backend='interpret' launched kernels: {plain['launches']}")
    for run in runs.values():
        check(len(run["reqs"]) == 2 * slots
              and run["calls"]["tokens"] == slots * n_new
              and all(len(r.out) == r.max_new_tokens
                      and 0 <= min(r.out) <= max(r.out) < cfg.vocab_size
                      for r in run["reqs"]),
              f"{name}: {run['calls']['tokens']} tokens")
    return cuda["launches"]


def gated_serve(cfg, params, make_requests, memories, backend, dev,
                slots: int = LM_SLOTS, max_seq: int = LM_MAX_SEQ) -> dict:
    """The engine's lockstep loop through ``make_prefill_step`` and
    ``make_decode_step`` with batch i's memory ``memories[i]`` (seeded
    image embeddings or frames where ``ServeEngine`` feeds the
    reference's zero stubs), the launch counts set to 0 just before and
    read just after -> {"reqs", "launches", "calls" (with host seconds
    and tokens), "stats"}, as ``serve_both`` reports a run."""
    import torch

    from repro_torch.kernels import _ext
    from repro_torch.serve.steps import (
        init_cache,
        make_decode_step,
        make_prefill_step,
    )

    reqs = make_requests(cfg.vocab_size)
    prefill = make_prefill_step(cfg, backend)
    decode = make_decode_step(cfg, backend)
    cache = init_cache(cfg, slots, max_seq, device=dev)
    tm = {"prefill_calls": 0, "prefill_s": 0.0, "decode_calls": 0,
          "decode_s": 0.0, "tokens": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, (S, toks, group) in enumerate(lm_batches(reqs, slots)):
            t = time.perf_counter()
            cur, cache = prefill(params, cache, {
                "tokens": torch.as_tensor(toks[:, :S], device=dev),
                MEM_KEY[cfg.family]: memories[i]})
            host = cur.cpu()
            tm["prefill_calls"] += 1
            tm["prefill_s"] += time.perf_counter() - t
            n = max(r.max_new_tokens for r in group)
            t = time.perf_counter()
            for step in range(n):
                for j, r in enumerate(group):
                    if len(r.out) < r.max_new_tokens:
                        r.out.append(int(host[j]))
                        tm["tokens"] += 1
                cur, cache = decode(params, cache, cur[:, None], S + step)
                host = cur.cpu()
            tm["decode_calls"] += n
            tm["decode_s"] += time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"reqs": reqs, "launches": dict(_ext.LAUNCHES), "calls": tm,
            "stats": {"wall_s": wall, "tok_per_s": tm["tokens"] / wall},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "backend": backend}


def end_to_end(params, cfg, reqs, preqs, dev, *, slots: int, max_seq: int,
               memories=None, experts=None):
    """The dense family's end-to-end values of a served run (``reqs`` on
    K7, ``preqs`` on the plain attention): each round's prefill logits
    against ``interpret``, the first differing tokens with the plain
    path's own margins, and decode against a teacher-forced forward
    (``teacher_forcing_rounds``); beside them how far the plain path's
    prefill logits move when only its attention's summation order
    changes -> (report, {"logits": logits within ``LM_LOGIT_TOL``,
    "tokens": margins within twice it, "teacher_forcing": its gates},
    each a list of (ok, message))."""
    import torch

    from repro_torch.kernels.flash_attention import attention_split_ref
    from repro_torch.models import attention as attn

    errs, reorder = [], []
    real_ref = attn.attention_ref
    for i, (S, toks, _) in enumerate(lm_batches(reqs, slots)):
        mem = memories and memories[i]
        lg, _ = prefill_logits(params, cfg, toks[:, :S], "cuda", experts,
                               dev, max_seq, mem)
        plg, _ = prefill_logits(params, cfg, toks[:, :S], "interpret",
                                experts, dev, max_seq, mem)
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
        errs.append(max_abs(lg, plg))
        # the plain path against itself, its attention's sums in 64-key
        # tiles
        attn.attention_ref = lambda q, k, v, **kw: attention_split_ref(
            q, k, v, tile=64, **kw)
        try:
            rlg, _ = prefill_logits(params, cfg, toks[:, :S], "interpret",
                                    experts, dev, max_seq, mem)
        finally:
            attn.attention_ref = real_ref
        reorder.append(max_abs(rlg, plg))
    diffs = first_diffs(params, cfg, reqs, preqs, experts, dev, slots,
                        max_seq, memories)
    tf, tf_gates = teacher_forcing_rounds(
        params, cfg, reqs, dev, slots=slots, memories=memories,
        experts=experts, preqs=preqs)
    rep = {"prefill_logit_err": errs, "plain_reorder_logit_err": reorder,
           "requests_differing": len(diffs), "first_diffs": diffs, **tf}
    gates = {
        "logits": [(max(errs) <= LM_LOGIT_TOL,
                    f"prefill logits differ by {errs} > {LM_LOGIT_TOL}")],
        "tokens": [(all(abs(d["margin"]) <= 2 * LM_LOGIT_TOL for d in diffs),
                    f"tokens first differ outside the margin: {diffs}")],
        "teacher_forcing": tf_gates}
    return rep, gates


def teacher_forcing_rounds(params, cfg, reqs, dev, *, slots: int,
                           memories=None, experts=None, preqs=None):
    """Decode through the cache against a teacher-forced forward, round
    by round: the K7 run's tokens (``reqs``) against a forward on K7,
    and, given the plain run's tokens (``preqs``), those against a
    forward on the plain attention -> (report, gates on the K7 one:
    agreement on at least ``LM_AGREE`` of the positions, each miss where
    the forward's top two lie within 2 x ``LM_LOGIT_TOL``)."""
    import numpy as np

    rep = {}
    for key, backend, rq in (("teacher_forcing", "cuda", reqs),
                             ("teacher_forcing_plain", "interpret", preqs)):
        if rq is None:
            continue
        agree, misses, drops = [], [], 0.0
        for i in range(len(rq) // slots):
            tf = teacher_forcing(params, cfg, rq[i * slots:(i + 1) * slots],
                                 experts, dev, backend, slots,
                                 memories and memories[i])
            agree += tf["agree"]
            misses += [m["margin"] for m in tf["misses"]]
            drops += tf["drop_frac_sum"]
        rep[key] = {"agree": float(np.mean(agree)), "agree_by_request": agree,
                    "miss_margins": misses, "moe_drop_frac_sum": drops}
    r = rep["teacher_forcing"]
    gates = [(all(m <= 2 * LM_LOGIT_TOL for m in r["miss_margins"]),
              f"decode misses teacher forcing outside the margin: "
              f"{r['miss_margins']}"),
             (r["agree"] >= LM_AGREE,
              f"decode against teacher forcing agrees on {r['agree']}")]
    return rep, gates


def cross_block_check(p, x, memory, cfg, dev, what: str) -> dict:
    """A cross-attention block's attention on K7 against the plain
    attention on its own inputs (the residual stream ``x``, normed by
    ``ln_cross``, and the memory): the prefill's non-causal call over
    every memory key, then the decode's, the last position's query
    against the keys and values in the cache's bf16.  Each call by
    ``attn_close``."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rmsnorm

    c = p["cross"]
    with torch.no_grad():
        q = attn.project_q(c, rmsnorm(p["ln_cross"], x, cfg.norm_eps), cfg)
        k, v = attn.project_kv(c, memory, cfg)
        got = {b: attn.prefill_attention(q, k, v, backend=b, causal=False)
               for b in ("cuda", "interpret")}
        kw = dict(causal=False, window=0, q_offset=0)
        out = {"prefill": attn_close(got, dev, f"{what} prefill",
                                     (q, k, v, k.shape[1], kw))}
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        qd = q[:, -1:].contiguous()
        got = {b: attn.prefill_attention(qd, kb, vb, backend=b,
                                         causal=False)
               for b in ("cuda", "interpret")}
        out["decode"] = attn_close(got, dev, f"{what} decode",
                                   (qd, kb, vb, kb.shape[1], kw))
    return out


def free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def seeded_params(cfg, dtype, dev, seed, experts=None):
    """-> (parameters from ``torch.Generator`` ``seed`` on the card, init
    seconds, GB)."""
    import torch

    from repro_torch.models.registry import init_params

    torch.cuda.synchronize()
    t = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(seed), device=dev, dtype=dtype,
                         experts=experts)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t, sum(
        x.numel() * x.element_size() for x in _leaves(params)) / 1e9


def path_mixtral_serve(dev):
    """``ServeEngine`` with Mixtral-8x7B at every published width and
    depth (32 layers, d_model 4,096, 32 query heads over 8 KV heads of
    128, a 4,096-key sliding window, 8 experts top-2 of d_ff 14,336,
    vocab 32,000), weights from ``torch.Generator`` seed 0 on the card,
    batch_slots 2, max_seq 4,352 (the rolling cache holds T = 4,096),
    the two rounds of ``MX_ROUNDS`` in one ``run`` per engine,
    ``backend="cuda"`` against ``"interpret"``: K7 32 x (prefill +
    decode calls) launches and nothing else; round 1's decode wraps the
    ring.  The earlier phases' weights are freed first.  Twice:

    * bf16 with experts 0-3 (this card's share, 48.3 GB; the kernels
      line counts this run): per-block gates on the path's own input
      (round 1's 4,224 tokens and 128 seeded ones, embedded and normed):
      layer 0's attention on K7 (a 4,350-token windowed prefill where
      the window binds, then 2 ring decode steps) and layer 0's MoE FFN
      against a plain per-expert gather, each within 8e-3 of max(1,
      |plain|).  The dense family's end-to-end values are reported.
    * f32 at 4 layers with all 8 experts (about 24 GB): every layer's
      attention (the same windowed prefill and ring steps) and MoE FFN
      on the plain run's own inputs within 1e-5 of the block's scale
      (attention plus twice the plain decomposition's spread), each
      round's routing on K7 first differing from ``interpret``'s at a
      near-tie (``ROUTE_MARGIN``), else the logits within
      ``LM_LOGIT_TOL``; tokens against ``interpret`` within the margin;
      teacher forcing over round 1's 4,224 and round 2's 64 positions
      on a drop-free rerun (``capacity_factor`` = E / k) on both
      engines, reported (``E2E_GATED``).

    -> the bf16 run's launches per kernel."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    held_gb = free_card()
    full = configs.get_config(MX_ARCH)
    n_new = sum(new for _, _, new in MX_ROUNDS)
    report, gates = {}, []
    for dtype, layers, experts in ((torch.bfloat16, full.num_layers,
                                    MX_EXPERTS),
                                   (torch.float32, MX_F32_LAYERS, None)):
        cfg = dataclasses.replace(full, num_layers=layers)
        params, init_s, gb = seeded_params(cfg, dtype, dev, MX_SEED, experts)
        runs = serve_both(cfg, params, mixtral_requests, n_new, dev, experts,
                          MX_SLOTS, MX_MAX_SEQ)
        launches = check_serve_runs("path_mixtral_serve", cfg, runs,
                                    MX_SLOTS, n_new)
        rep = dict(num_layers=layers, experts=None if experts is None else
                   [experts.start, experts.stop - 1], weights_gb=gb,
                   init_s=init_s, **run_fields(runs))
        reqs, preqs = runs["cuda"]["reqs"], runs["interpret"]["reqs"]
        e2e, e2e_gates = end_to_end(params, cfg, reqs, preqs, dev,
                                    slots=MX_SLOTS, max_seq=MX_MAX_SEQ,
                                    experts=experts)
        rep["published_capacity"] = e2e
        batches = lm_batches(reqs, MX_SLOTS)
        _, toks, _ = batches[0]
        extra = np.random.default_rng(MX_SEED).integers(
            0, cfg.vocab_size, (MX_SLOTS, MX_BLOCK_S - toks.shape[1]))
        long_toks = np.concatenate([toks, extra.astype(np.int32)], 1)
        if dtype == torch.bfloat16:
            main_launches = launches
            h = block_input(params, cfg, 0, "ln1", long_toks, dev)
            x = block_input(params, cfg, 0, "ln2", long_toks, dev)
            rep["block_err"] = {
                "attention": self_block_check(
                    params["layers"][0]["attn"], h, cfg, dev,
                    "layer 0 attention", n_decode=MX_RING_STEPS,
                    max_seq=MX_MAX_SEQ),
                "moe": moe_block_check(params, cfg, None, experts, dev, x=x)}
        else:
            rep["routing"] = []
            for i, (S, toks, _) in enumerate(batches):
                traces = {b: layer_trace(params, cfg, toks[:, :S], b, dev,
                                         MX_MAX_SEQ)
                          for b in ("cuda", "interpret")}
                div = routing_divergence(traces["cuda"],
                                         traces["interpret"],
                                         cfg.num_experts_per_tok)
                del traces
                rep["routing"].append(div)
                first, gap = div["first_flip_layer"], \
                    div["first_flip_max_gap"]
                gates.append((
                    div["logit_err"] <= LM_LOGIT_TOL if first is None
                    else gap <= ROUTE_MARGIN,
                    f"f32 round {i + 1}: logits differ by "
                    f"{div['logit_err']}, routing first differs at layer "
                    f"{first} with a gap of {gap} > {ROUTE_MARGIN}"))
            plain = layer_trace(params, cfg, long_toks, "interpret", dev,
                                MX_MAX_SEQ)
            rep["block_err"] = []
            for layer in range(cfg.num_layers):
                lp = params["layers"][layer]
                h = rmsnorm(lp["ln1"], plain["inputs"][layer], cfg.norm_eps)
                rep["block_err"].append({
                    "layer": layer,
                    "attention": self_block_check(
                        lp["attn"], h, cfg, dev, f"layer {layer} attention",
                        n_decode=MX_RING_STEPS, max_seq=MX_MAX_SEQ),
                    "moe": moe_block_check(params, cfg, None, None, dev,
                                           layer=layer,
                                           x=plain["moe_inputs"][layer])})
            del plain
            # the dense family's gates on a drop-free rerun on K7
            free = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts
                / cfg.num_experts_per_tok)
            free_reqs = {}
            for backend in ("cuda", "interpret"):
                eng = ServeEngine(free, params, batch_slots=MX_SLOTS,
                                  max_seq=MX_MAX_SEQ, backend=backend,
                                  device=dev)
                free_reqs[backend] = mixtral_requests(cfg.vocab_size)
                for r in free_reqs[backend]:
                    eng.submit(r)
                eng.run(max_steps=n_new)
                del eng
            rep["drop_free"], free_gates = teacher_forcing_rounds(
                params, free, free_reqs["cuda"], dev, slots=MX_SLOTS,
                preqs=free_reqs["interpret"])
            rep["drop_free"]["capacity_factor"] = free.capacity_factor
            # tokens against interpret at the published capacity and
            # teacher forcing on the drop-free rerun, where E2E_GATED
            # says so
            e2e_gates["teacher_forcing"] = free_gates
            for k in E2E_GATED[MX_ARCH]:
                gates += e2e_gates[k]
        rep["phase_peak_gb"] = max(runs["cuda"]["peak_gb"],
                                   torch.cuda.max_memory_allocated(dev) / 1e9)
        report["bf16" if dtype == torch.bfloat16 else "f32"] = rep
        del params, runs
        free_card()
    emit({"phase": "path_mixtral_serve", "arch": MX_ARCH,
          "params": full.param_count(), "batch_slots": MX_SLOTS,
          "max_seq": MX_MAX_SEQ, "window": full.sliding_window,
          "held_gb_before": held_gb,
          "prompt_lens": [len(r.prompt) for r in mixtral_requests(
              full.vocab_size)],
          "max_new_tokens": [new for _, _, new in MX_ROUNDS],
          "logit_tol": LM_LOGIT_TOL, **report,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return main_launches


def set_gates(params, dev, seed: int) -> list:
    """Every gated cross-attention's tanh gate drawn from [0.3, 1.0)
    (the init's 0 hides the cross-attention) -> the gates."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for layer in params["layers"]:
        if "gate" in layer.get("cross", {}):
            layer["cross"]["gate"].copy_(0.3 + 0.7 * torch.rand(
                (), generator=g, device=dev))
            out.append(float(layer["cross"]["gate"]))
    return out


def seeded_memories(cfg, reqs, dev, seed: int, slots: int = LM_SLOTS):
    """Each lockstep batch's memory, bf16, ``MEM_STD`` x normal from
    ``seed``: a vlm's image embeddings [slots, num_image_tokens, d] or an
    encdec's frames [slots, S, d] (the batch's prompt length)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for S, _, _ in lm_batches(reqs, slots):
        M = cfg.num_image_tokens if cfg.family == "vlm" else S
        out.append((MEM_STD * torch.randn((slots, M, cfg.d_model),
                                          generator=g, device=dev)
                    ).to(torch.bfloat16))
    return out


def cross_serve(name, arch, dev, block_layers) -> dict:
    """The vlm and encdec paths (see ``path_vlm_serve`` and
    ``path_encdec_serve``): for bf16 then f32 weights at full width and
    depth, the engine on its zero stubs (tok/s; K7 ``k7_per_run``
    launches and nothing else), then the gated run, ``gated_serve`` with
    non-zero gates and seeded memories on K7 and on ``interpret``, its
    end-to-end values (those of ``E2E_GATED`` gated in f32), and the
    attention blocks of ``block_layers(cfg, dtype)`` -> the bf16 stub
    run's launches."""
    import torch

    from repro_torch import configs
    from repro_torch.models.layers import rmsnorm

    t0 = time.perf_counter()
    held_gb = free_card()
    cfg = configs.get_config(arch)
    n_new = sum(new for _, _, new in MOE_ROUNDS)
    report, gates = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        params, init_s, gb = seeded_params(cfg, dtype, dev, LM15_SEED)
        runs = serve_both(cfg, params, moe_requests, n_new, dev)
        launches = check_serve_runs(name, cfg, runs, LM_SLOTS, n_new)
        rep = dict(weights_gb=gb, init_s=init_s, stubs=run_fields(runs))
        del runs
        rep["gates"] = set_gates(params, dev, LM15_SEED + 1)
        memories = seeded_memories(cfg, moe_requests(cfg.vocab_size), dev,
                                   LM15_SEED + 2)
        gated = {b: gated_serve(cfg, params, moe_requests, memories, b, dev)
                 for b in ("cuda", "interpret")}
        check_serve_runs(f"{name} (gated)", cfg, gated, LM_SLOTS, n_new)
        rep["gated"] = run_fields(gated)
        e2e, e2e_gates = end_to_end(
            params, cfg, gated["cuda"]["reqs"], gated["interpret"]["reqs"],
            dev, slots=LM_SLOTS, max_seq=LM_MAX_SEQ, memories=memories)
        rep["gated"].update(e2e)
        if dtype == torch.bfloat16:
            main_launches = launches
        else:
            for k in E2E_GATED[arch]:
                gates += e2e_gates[k]
        # the blocks, on the plain run's own inputs: round 1's prefill
        # and its first new token
        S, toks, _ = lm_batches(gated["interpret"]["reqs"])[0]
        tr = layer_trace(params, cfg, toks[:, :S + 1], "interpret", dev,
                         memory=memories[0])
        blocks = {}
        n_enc = len(params.get("encoder", []))
        self_layers, cross_layers, enc_layers = block_layers(cfg, dtype)
        for layer in enc_layers:
            p = params["encoder"][layer]
            h = rmsnorm(p["ln1"], tr["inputs"][layer], cfg.norm_eps)
            blocks[f"encoder_{layer}"] = self_block_check(
                p["attn"], h, cfg, dev, f"encoder layer {layer}",
                causal=False, n_decode=0)
        for layer in self_layers:
            p = params["layers"][layer]
            h = rmsnorm(p["ln1"], tr["inputs"][n_enc + layer], cfg.norm_eps)
            blocks[f"self_{layer}"] = self_block_check(
                p["attn"], h, cfg, dev, f"layer {layer} self-attention")
        cross_ids = [l for l, (s, _) in enumerate(tr["layers"][n_enc:])
                     if s.cross]
        for layer in cross_layers:
            p, x, mem = tr["cross"][cross_ids.index(layer)]
            blocks[f"cross_{layer}"] = cross_block_check(
                params["layers"][layer], x, mem, cfg, dev,
                f"layer {layer} cross-attention")
        del tr
        rep["block_err"] = blocks
        rep["phase_peak_gb"] = max(gated["cuda"]["peak_gb"],
                                   torch.cuda.max_memory_allocated(dev) / 1e9)
        report[key] = rep
        del params, gated, memories
        free_card()
    emit({"phase": name, "arch": arch, "params": cfg.param_count(),
          "batch_slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
          "held_gb_before": held_gb,
          "prompt_lens": [len(r.prompt) for r in moe_requests(
              cfg.vocab_size)],
          "max_new_tokens": [new for _, _, new in MOE_ROUNDS],
          "memory_std": MEM_STD, "logit_tol": LM_LOGIT_TOL, **report,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return main_launches


def path_vlm_serve(dev):
    """``ServeEngine`` with Llama-3.2-Vision-11B at every published width
    and depth (40 layers, 8 of them with a gated cross-attention over
    6,404 image tokens; d_model 4,096, 32 query heads over 8 KV heads of
    128, d_ff 14,336, vocab 128,256), weights from ``torch.Generator``
    seed 0 on the card, batch_slots 4, max_seq 1,024, the rounds of
    ``MOE_ROUNDS``: K7 48 x (prefill + decode calls) launches and
    nothing else.  The engine feeds the reference's zero image
    embeddings and the gates start at 0, either of which hides the
    cross-attention, so that run gives tok/s, and the gates hold a run
    of ``make_prefill_step`` / ``make_decode_step`` with the gates drawn
    from [0.3, 1) and seeded image embeddings: each cross block (prefill,
    and decode against the 6,404 cached keys) and layer 1's
    self-attention block (every layer's in f32; prefill and a decode
    step) on K7 against the plain attention on the plain run's own
    inputs, within 8e-3 of max(1, |plain|) in bf16 and 1e-5 of the
    block's scale (plus twice the plain decomposition's spread) in f32;
    the dense family's end-to-end values are reported (``E2E_GATED``;
    20.2 GB in bf16, 40.4 GB in f32).  -> the bf16 stub run's
    launches."""
    import torch

    def blocks(cfg, dtype):
        every = list(range(cfg.num_layers))
        return (every if dtype == torch.float32 else [1],
                every[::cfg.cross_attn_period], [])

    return cross_serve("path_vlm_serve", VL_ARCH, dev, blocks)


def path_encdec_serve(dev):
    """``ServeEngine`` with SeamlessM4T-large-v2 at every published width
    and depth (a 12-layer non-causal encoder over the audio front end's
    frames, 12 decoder layers each with causal self-attention and a
    cross-attention over the encoded frames; d_model 1,024, 16 heads of
    64, d_ff 8,192, vocab 256,206), weights from ``torch.Generator`` seed
    0, batch_slots 4, max_seq 1,024, the rounds of ``MOE_ROUNDS``: K7 36
    launches a prefill (12 encoder, 12 self, 12 cross) and 24 a decode
    step, nothing else.  The engine's zero frames give tok/s; the gates
    hold a run with seeded frames of each round's prompt length: the
    encoder's self-attention (prefill), the decoder's self-attention
    and its cross-attention (prefill and decode) on K7 against the
    plain attention, layer 0 in bf16 and every layer in f32, by the
    block rules of ``path_vlm_serve``; the dense family's end-to-end
    values are reported (``E2E_GATED``).  -> the bf16 stub run's
    launches."""
    import torch

    def blocks(cfg, dtype):
        every = dtype == torch.float32
        dec = list(range(cfg.num_decoder_layers)) if every else [0]
        enc = list(range(cfg.num_encoder_layers)) if every else [0]
        return dec, dec, enc

    return cross_serve("path_encdec_serve", ED_ARCH, dev, blocks)


def path_xlstm_serve(dev):
    """``ServeEngine`` with xLSTM-1.3B at every published width and
    ``XL_LAYERS`` of its 48 blocks (an sLSTM every 8th, mLSTM otherwise;
    d_model 2,048, 4 heads of 512, vocab 50,304), weights from
    ``torch.Generator`` seed 0, batch_slots 4, max_seq 1,024, the rounds
    of ``XL_ROUNDS`` through the engine on ``backend="cuda"`` and ``"interpret"``: no kernel
    launches under either (the blocks are plain PyTorch, as the
    reference's are jnp), every request served.  In bf16 then f32:
    decode through the recurrent state against a teacher-forced forward
    over each round's prompts and new tokens on at least ``LM_AGREE`` of
    the positions, in f32 each miss where the forward's top two lie
    within 2 x ``LM_LOGIT_TOL`` (in bf16 the misses' margins are
    reported: the chunkwise forward and the stepwise decode round the
    blocks' bf16 outputs at different points); prefill ms, decode ms a
    step and tok/s.  -> the bf16 run's launches (all 0)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _ext

    t0 = time.perf_counter()
    held_gb = free_card()
    cfg = dataclasses.replace(configs.get_config(XL_ARCH),
                              num_layers=XL_LAYERS)
    n_new = sum(new for _, _, new in XL_ROUNDS)
    report, gates = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        params, init_s, gb = seeded_params(cfg, dtype, dev, LM15_SEED)
        runs = serve_both(cfg, params, xlstm_requests, n_new, dev)
        zero = dict.fromkeys(_ext.LAUNCHES, 0)
        for b, run in runs.items():
            check(run["launches"] == zero,
                  f"path_xlstm_serve ({b}) launched {run['launches']}")
            check(len(run["reqs"]) == 2 * LM_SLOTS
                  and run["calls"]["tokens"] == LM_SLOTS * n_new
                  and all(len(r.out) == r.max_new_tokens
                          and 0 <= min(r.out) <= max(r.out)
                          < cfg.vocab_size for r in run["reqs"]),
                  f"path_xlstm_serve ({b}): {run['calls']['tokens']} tokens")
        if dtype == torch.bfloat16:
            main_launches = runs["cuda"]["launches"]
        reqs = runs["cuda"]["reqs"]
        agree, misses = [], []
        for i in range(len(XL_ROUNDS)):
            tf = teacher_forcing(params, cfg, reqs[i * LM_SLOTS:(i + 1)
                                                   * LM_SLOTS], None, dev)
            agree += tf["agree"]
            misses += [m["margin"] for m in tf["misses"]]
        rep = dict(weights_gb=gb, init_s=init_s, **run_fields(runs),
                   engines_same_tokens=[r.out for r in reqs] == [
                       r.out for r in runs["interpret"]["reqs"]],
                   teacher_forcing_agree=float(np.mean(agree)),
                   teacher_forcing_agree_by_request=agree,
                   teacher_forcing_miss_margins=misses)
        report["bf16" if dtype == torch.bfloat16 else "f32"] = rep
        # in bf16 the chunkwise forward and the stepwise decode round
        # the blocks' bf16 outputs at different points, so a miss may sit
        # at a larger margin there: reported
        if dtype == torch.float32:
            gates.append((
                all(m <= 2 * LM_LOGIT_TOL for m in misses),
                f"xLSTM f32: decode misses teacher forcing outside the "
                f"margin: {misses}"))
        gates += [
            (np.mean(agree) >= LM_AGREE,
             f"xLSTM {dtype}: decode against teacher forcing agrees on "
             f"{np.mean(agree)}")]
        del params, runs
        free_card()
    emit({"phase": "path_xlstm_serve", "arch": XL_ARCH,
          "num_layers": XL_LAYERS, "params": cfg.param_count(),
          "batch_slots": LM_SLOTS,
          "max_seq": LM_MAX_SEQ, "held_gb_before": held_gb,
          "prompt_lens": [len(r.prompt) for r in xlstm_requests(
              cfg.vocab_size)],
          "max_new_tokens": [new for _, _, new in XL_ROUNDS],
          "logit_tol": LM_LOGIT_TOL, **report,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return main_launches


# ------------------------------------------------- slice 16: LM training

# the training path: Qwen3-1.7B at every published width and depth, AdamW
# with f32 master weights and bf16 compute, block remat, K7 and K7b,
# TokenDataset(seed=0) batches of 4 x 1,024
TRAIN_ARCH, TRAIN_SEED, TRAIN_B, TRAIN_S, TRAIN_STEPS = (
    "qwen3-1.7b", 0, 4, 1024, 8)
TRAIN_SETTINGS = dict(peak_lr=1e-3, warmup=2, total_steps=8)
# step 1 on K7 / K7b against backend="interpret" on the same params and
# batch: the loss (about 11.9 = ln 151,936 at init) within 1e-2 and the
# gradient norm within 2 % (bf16 compute rounds differently where the
# attention's rounding differs, as the CPU tests bound the reference)
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 1e-2, 0.02
# the same model at 4 layers in f32: each gradient within 1e-4 of its
# largest value against interpret's (the CPU tests hold the reference's
# f32 gradients at that bound; K7 / K7b hold 1e-5 of their outputs)
TRAIN_F32_LAYERS, TRAIN_F32_B, TRAIN_F32_TOL = 4, 2, 1e-4
# restart on the card: the 4-layer smoke config, a checkpoint every 4
# steps, 8 steps; the replayed params within 1e-6 of max|p| (not bit for
# bit: the embedding's backward accumulates with atomics on the card)
RESTART_STEPS, RESTART_EVERY, RESTART_S, RESTART_TOL = 8, 4, 64, 1e-6

# K7b's cases, each in bf16 and f32: name, B, Sq, Skv, H, K, D, causal,
# window, q_offset, skv (None: Skv).  Qwen3's training calls (S = 1,024
# and 2,048), Mixtral's window past the window, the vision and Seamless
# cross-attention (Sq != Skv), Seamless's encoder (D = 64), the smoke
# width D = 16 with a window, an offset and skv < Skv, D = 32 non-causal,
# a ragged S with a window, and rows whose keys are all masked (a window
# past skv) at D = 16 and 128
K7B_FORMS = (
    ("qwen3_train_1024", 4, 1024, 1024, 16, 8, 128, True, 0, 0, None),
    ("qwen3_train_2048", 4, 2048, 2048, 16, 8, 128, True, 0, 0, None),
    ("mixtral_window", 1, 4352, 4352, 32, 8, 128, True, 4096, 0, None),
    ("vlm_cross", 1, 512, 6404, 32, 8, 128, False, 0, 0, None),
    ("seamless_cross", 4, 32, 512, 16, 16, 64, False, 0, 0, None),
    ("seamless_encoder", 2, 512, 512, 16, 16, 64, False, 0, 0, None),
    ("smoke_d16", 2, 100, 130, 4, 2, 16, True, 8, 5, 120),
    ("d32", 2, 65, 97, 8, 2, 32, False, 8, 5, None),
    ("ragged_w256", 2, 1000, 1000, 16, 8, 128, True, 256, 0, None),
    ("fully_masked_d16", 1, 20, 50, 4, 2, 16, True, 8, 40, 45),
    ("fully_masked_d128", 1, 70, 100, 16, 8, 128, False, 16, 80, 90),
    ("jamba_large_scores", 4, 512, 512, 64, 8, 128, True, 0, 0, None),
)
# the cases whose q is scaled, each with its factor: Jamba-1.5-Large's
# attention shape (64 query heads over 8, D = 128, S = 512) with scores
# that spread near 360 over a row, as the seeded Jamba's do without
# QK-norm (unit q and k give scores of unit spread after the scale; 60
# of it spans about 6 x 60 over 512 keys).  K7b's scores sum on the
# tensor cores, whose k-step sums are coarser than f32
# (flash_prefill.cu's header).  Jamba's attention trains on K7b since
# K8 has a backward (path_hybrid_train), so these cases are gated
# within K7_TOL like the rest, and their score spread is reported on a
# line of its own.  In the f32 case no f32 evaluation comes within
# K7_TOL of the exact gradient: against autograd's gradient in f64
# (attention_f64), dq of K7b lies 5.40e-5 of its largest value from it,
# attention_bwd_ref 5.33e-5 and autograd's f32 gradient of
# attention_ref 5.16e-5, while K7b lies 1.03e-5 from the last, past
# K7_TOL (an H100 80GB HBM3 at 700 W).  So in the cases of
# K7B_F64_AUTOGRAD the autograd yardstick is the f64 gradient, and K7b
# is held within K7_TOL plus the f32 plain evaluations' own distance
# from it, measured in the same run (``k7b_against_plain``); against
# its plain version it is held within K7_TOL as everywhere.
K7B_LARGE_SCORES = {"jamba_large_scores": 60.0}
K7B_F64_AUTOGRAD = ("jamba_large_scores_f32",)
K7B_CASES = tuple((c[0] + ("_f32" if dt == "float32" else ""),) + c[1:]
                  + (dt,) for c in K7B_FORMS
                  for dt in ("bfloat16", "float32"))
# the timed K7b calls (names of K7B_CASES)
K7B_TIMED = ("qwen3_train_1024", "qwen3_train_1024_f32", "qwen3_train_2048",
             "mixtral_window", "seamless_encoder", "vlm_cross")
K7B_TIMED_LAUNCHES = 20


def k7b_names(dtype: str, D: int) -> list:
    """K7b's three kernels, as the profiler names them: bf16 on the
    tensor cores (``wgmma``), f32 on the CUDA cores."""
    passes = ("stats", "dkdv", "dq")
    if dtype == "float32":
        return [f"fa_bwd_{k}_kernel<float, {D}>" for k in passes]
    return [f"fa_bwd_{k}_wgmma_kernel<{D}>" for k in passes]


def k7b_bound(B, Sq, Skv, H, K, D, itemsize, pairs, kv_rows):
    """q, dO and dq, the live K and V rows, and dk and dv (every key row)
    once over the HBM rate; the backward's five products (S recomputed,
    dP, dV, dK, dQ), 2 * D operations each per live pair per head, over
    the bf16 tensor-core rate (itemsize 2) or the f32 rate."""
    moved = itemsize * (3 * B * Sq * H * D + 2 * B * kv_rows * K * D
                        + 2 * B * Skv * K * D)
    t_b = moved / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    t_o = 10.0 * B * H * D * pairs / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k7b_inputs(dev, B, Sq, Skv, H, K, D, dt, seed, q_scale=1.0):
    import torch

    q, k, v = k7_inputs(dev, B, Sq, Skv, H, K, D, getattr(torch, dt), seed)
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(q.dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev).to(q.dtype)


def attention_f64(q, k, v, *, causal, window, q_offset):
    """``attention_ref``'s function in f64 on the f64 copies of q, k, v,
    the scores times the scale K7 and K7b are given (the f32 nearest 1 /
    sqrt(D)) -> [B, Sq, H, D] f64."""
    import math

    import torch

    B, Sq, H, D = q.shape
    K = k.shape[2]
    f64 = torch.float64
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))
    s = torch.einsum("bskgd,btkd->bkgst",
                     q.to(f64).reshape(B, Sq, K, H // K, D), k.to(f64))
    s = s * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    p = torch.softmax(torch.where(mask[None, None, None], s, -1e30), -1)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.to(f64))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def k7b_against_plain(q, k, v, do, dt: str, what: str, *, skv: int,
                      f64_autograd: bool = False, **kw) -> dict:
    """K7b on (q, k, v, dO) twice (bit-identical), against
    ``attention_bwd_ref`` on the same inputs, against autograd's
    gradient of ``attention_ref`` on their f32 copies and, in bf16,
    against ``attention_bwd_ref(split_p=True)`` (the plain form of the
    bf16 kernels' schedule), each of dq, dk and dv within ``K7_TOL[dt]``
    of the plain gradient's largest value.  With ``f64_autograd`` the
    autograd yardstick is the gradient of ``attention_f64`` (rounded to
    f32), the exact one for f32 inputs, and K7b is held within
    ``K7_TOL[dt]`` plus the f32 plain evaluations' own distance from it
    (``attention_bwd_ref``'s and autograd's of ``attention_ref``),
    measured here.  -> {"err": worst relative to that value,
    "err_autograd": ..., "err_split": ... (bf16), "plain_pair": the
    plain evaluations' own distance from the autograd yardstick}."""
    import torch

    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref,
        attention_ref,
        flash_attention_bwd_launch,
    )

    got = flash_attention_bwd_launch(q, k, v, do, skv=skv, **kw)
    again = flash_attention_bwd_launch(q, k, v, do, skv=skv, **kw)
    plain = {"err": attention_bwd_ref(q, k, v, do, skv=skv, **kw)}
    if dt == "bfloat16":
        plain["err_split"] = attention_bwd_ref(q, k, v, do, skv=skv,
                                               split_p=True, **kw)
    def autograd(fn, wide):
        qa, ka, va = (t.detach().to(wide).requires_grad_()
                      for t in (q, k, v))
        with torch.enable_grad():
            fn(qa, ka[:, :skv], va[:, :skv], **kw).backward(do.to(wide))
        return tuple(t.grad.float() for t in (qa, ka, va))

    own = [plain["err"]]
    if f64_autograd:
        own.append(autograd(attention_ref, torch.float32))
        plain["err_autograd"] = autograd(attention_f64, torch.float64)
    else:
        plain["err_autograd"] = autograd(attention_ref, torch.float32)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K7b {what}: two calls differ")
    out = dict.fromkeys(plain, 0.0) | {"plain_pair": 0.0}
    for i, (name, g) in enumerate(zip(("dq", "dk", "dv"), got)):
        check(g.dtype == q.dtype and g.shape == plain["err"][i].shape,
              f"K7b {what}: {name} {g.dtype} {tuple(g.shape)}")
        want = plain["err_autograd"][i]
        pair = max(max_abs(o[i], want) for o in own) / max(
            float(want.abs().max()), 1e-30)
        out["plain_pair"] = max(out["plain_pair"], pair)
        for key, grads in plain.items():
            want = grads[i]
            scale = float(want.float().abs().max())
            err = max_abs(g, want) / max(scale, 1e-30)
            allow = K7_TOL[dt] + (pair if f64_autograd
                                  and key == "err_autograd" else 0.0)
            check(err <= allow, f"K7b {what}: {name} {err} of max|plain| "
                  f"{scale} from the {key} (allowed {allow})")
            out[key] = max(out[key], err)
    return out


def kernels_check_lm_bwd(dev):
    """K7b against its plain version (``attention_bwd_ref``), against
    autograd's gradient of ``attention_ref`` in f32 and, in bf16, against
    the plain form of its schedule (``split_p=True``) at every case of
    ``K7B_CASES``, each of dq, dk, dv within ``K7_TOL`` of the plain
    gradient's largest value (in the cases of ``K7B_F64_AUTOGRAD``
    autograd's gradient taken in f64); two calls bit-identical.  The
    cases of ``K7B_LARGE_SCORES`` are also reported with their score
    spread on a line of their own.
    -> {"flash_attention_bwd": the worst error relative to that value}."""
    rows, worst, large = [], 0.0, []
    for i, (name, B, Sq, Skv, H, K, D, causal, window, q_offset, skv,
            dt) in enumerate(K7B_CASES):
        skv = Skv if skv is None else skv
        q_scale = K7B_LARGE_SCORES.get(name.removesuffix("_f32"), 1.0)
        q, k, v, do = k7b_inputs(dev, B, Sq, Skv, H, K, D, dt, 100 + i,
                                 q_scale)
        kw = dict(causal=causal, window=window, q_offset=q_offset, skv=skv)
        f64 = name in K7B_F64_AUTOGRAD
        e = k7b_against_plain(q, k, v, do, dt, name, f64_autograd=f64, **kw)
        row = {"case": name, "dtype": dt, "shape": [B, Sq, Skv, H, K, D],
               "causal": causal, "window": window, "q_offset": q_offset,
               "skv": skv, "deterministic": True, "f64_autograd": f64, **e}
        worst = max(worst, e["err"])
        if q_scale != 1.0:
            large.append({**row, "q_scale": q_scale,
                          **score_spread(q[:1], k[:1, :skv], **kw)})
        rows.append(row)
        del q, k, v, do
        free_card()
    emit({"phase": "kernels_check_lm_bwd", "tol": K7_TOL, "cases": rows})
    emit({"phase": "k7b_large_scores", "cases": large})
    return {"flash_attention_bwd": worst}


def score_spread(q, k, *, causal, window, q_offset, skv) -> dict:
    """Each row's live scores after the scale (batch 0, every head): the
    median and largest spread (max - min) over the rows, and the largest
    |score|."""
    import torch

    from repro_torch.kernels.flash_attention.ref import NEG_INF

    D, G = q.shape[3], q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) / math.sqrt(D)
    i = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
    j = torch.arange(kf.shape[1], device=q.device)[None, :]
    live = j < skv
    if causal:
        live = live & (j <= i)
    if window:
        live = live & (j > i - window)
    hi = torch.where(live, s, NEG_INF).amax(-1)
    lo = torch.where(live, s, -NEG_INF).amin(-1)
    spread = (hi - lo).flatten()
    return {"score_spread_median": float(spread.median()),
            "score_spread_max": float(spread.max()),
            "score_abs_max": float(torch.maximum(hi, -lo).max())}


def kernels_time_lm_bwd(dev):
    """K7b at ``K7B_TIMED``: wrapper ms (CUDA events), device ms
    (profiler: its three kernels summed per call), the plain version's
    ms, and ``scaled_dot_product_attention``'s backward on the same
    inputs (``torch.autograd.grad`` through it: CUDA-event ms as
    ``library_ms`` and its kernels' device ms as ``library_kernel_ms``),
    and the bound.  -> {case: numbers}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref,
        flash_attention_bwd_launch,
    )
    from repro_torch.kernels.flash_attention.ref import live_keys

    cases = {c[0]: c for c in K7B_CASES}
    out = {}
    for name in K7B_TIMED:
        (_, B, Sq, Skv, H, K, D, causal, window, q_offset, skv,
         dt) = cases[name]
        skv = Skv if skv is None else skv
        q, k, v, do = k7b_inputs(dev, B, Sq, Skv, H, K, D, dt, 7)
        kw = dict(causal=causal, window=window, q_offset=q_offset, skv=skv)
        k7b = lambda: flash_attention_bwd_launch(q, k, v, do, **kw)  # noqa
        names = k7b_names(dt, D)
        calls = {names[0]: k7b, **{n: lambda: None for n in names[1:]}}
        for _ in range(3):
            seen = kernel_device_ms(calls, K7B_TIMED_LAUNCHES)
            if all(seen[n]["events"] == K7B_TIMED_LAUNCHES for n in names):
                break
        parts = {n: seen[n]["ms"] for n in names}
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t[:, :skv].transpose(1, 2).contiguous().requires_grad_()
                  for t in (k, v))
        mask = None
        if window:
            # the band K7's window keeps, as SDPA's boolean mask
            i = torch.arange(Sq, device=dev)[:, None] + q_offset
            j = torch.arange(skv, device=dev)[None, :]
            mask = j > i - window
            if causal:
                mask = mask & (j <= i)
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qt, kt, vt), dot, retain_graph=True)
        got = k7b()
        ldq = lib()[0].transpose(1, 2)
        # the yardstick must compute K7b's function
        check(max_abs(got[0], ldq) <= 0.1 * float(got[0].float().abs().max()),
              f"K7b {name} and SDPA's backward compute different functions")
        pairs = live_pairs(Sq, skv, causal, window, q_offset)
        lo, hi = live_keys(Sq, skv, causal=causal, window=window,
                           q_offset=q_offset)
        out[name] = dict(
            ms=time_ms(k7b, K7B_TIMED_LAUNCHES),
            kernel_ms=(sum(parts.values()) if None not in parts.values()
                       else None),
            kernel_parts_ms=parts,
            kernel_events={n: seen[n]["events"] for n in names},
            plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, do, **kw), 3),
            library_ms=time_ms(lib, K7B_TIMED_LAUNCHES),
            library_kernel_ms=next(
                (t for t in (call_device_ms(lib) for _ in range(3)) if t),
                None),
            bound=k7b_bound(B, Sq, Skv, H, K, D, q.element_size(), pairs,
                            hi - lo),
            shape=[B, Sq, Skv, H, K, D], dtype=dt, causal=causal,
            window=window, q_offset=q_offset, skv=skv, pairs=pairs,
            kernels=names)
        del q, k, v, do, qt, kt, vt, lib_out, got, ldq
        free_card()
    emit({"phase": "kernels_time_lm_bwd", **out, "nvidia_smi": nvidia_smi()})
    return out


def f32_grads(params, cfg, batch, backend: str):
    """-> (loss, gradients in ``tree_leaves`` order) of ``total_loss``
    after ``forward`` in the params' own dtype (no bf16 cast), by
    autograd."""
    import torch

    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.models.transformer import forward
    from repro_torch.train import total_loss

    tree = tree_map(lambda x: x.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits, _, aux = forward(tree, cfg, tokens=batch["tokens"],
                                 mode="train", backend=backend)
        loss, _ = total_loss(logits, batch["targets"], aux)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
    return float(loss.detach()), grads


def train_step_profile(step, state, batch) -> dict:
    """One more training step under torch.profiler: device ms by kernel
    group (K7's forward kernels, K7b's, K8's, K8b's, cuBLAS / CUTLASS
    matrix products, the rest: elementwise, reductions, the optimizer),
    the device's busy
    share of the profiled step's wall time, and the ten largest kernels.
    It updates ``state`` as any step does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    avg = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups = dict.fromkeys(("k7", "k7b", "k8", "k8b", "matmul", "other"),
                           0.0)
    for e in avg:
        key = e.key.lower()
        group = ("k7b" if "fa_bwd_" in key else
                 "k7" if "fa_prefill" in key or "fa_decode" in key
                 or "fa_combine" in key else
                 "k8b" if "selective_scan_bwd" in key else
                 "k8" if "selective_scan_" in key else
                 "matmul" if any(w in key for w in (
                     "gemm", "xmma", "cutlass", "nvjet", "matmul")) else
                 "other")
        groups[group] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "by_group_ms": groups,
            "top": [[e.key[:90], e.count, e.self_device_time_total / 1e3]
                    for e in top]}


def path_lm_train(dev):
    """LM training on the card: Qwen3-1.7B at every published width and
    depth (28 layers, d_model 2,048, vocab 151,936, 1.72 B parameters),
    ``init_train_state`` (AdamW, f32 master weights, seeded), bf16
    compute, block remat, ``backend="cuda"``: ``TRAIN_STEPS`` steps of
    ``make_train_step`` on ``TokenDataset(seed=0)`` batches of 4 x 1,024,
    the launch counts set to 0 just before them and read just after (K7
    2 x 28 a step: the forward and the remat's recompute; K7b 28).
    Gates: every loss finite, the last below the first; step 1's loss
    within ``TRAIN_LOSS_TOL`` and gradient norm within
    ``TRAIN_GNORM_TOL`` of the same step's on ``backend="interpret"``
    (same params and batch, nothing updated); K7b on layer 0's and layer
    27's own q, k, v and dO of step 1 within ``K7_TOL`` of the plain
    gradients; the same model at 4 layers in f32, every parameter's
    gradient within ``TRAIN_F32_TOL`` of its largest value against
    ``interpret``'s.  One more step, after the counts are read, runs under
    the profiler (``train_step_profile``).  -> the main run's launch
    counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import _ext
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.registry import init_params, model_flops
    from repro_torch.configs import ShapeConfig
    from repro_torch.optim import global_norm
    from repro_torch.train import (
        TrainSettings,
        init_train_state,
        make_grad_fn,
        make_train_step,
    )

    t0 = time.perf_counter()
    held_gb = free_card()
    cfg = get_config(TRAIN_ARCH)
    settings = TrainSettings(**TRAIN_SETTINGS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = init_train_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(TRAIN_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state_gb = sum(x.numel() * x.element_size()
                   for x in _leaves(state)) / 1e9
    data = TokenDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch_at(i).items()} for i in range(TRAIN_STEPS)]

    # step 1 on the plain attention: its loss and gradient norm, nothing
    # updated
    m_plain, g = make_grad_fn(cfg, settings, backend="interpret")(
        state["params"], batches[0])
    loss_plain = float(m_plain["loss"])
    gnorm_plain = float(global_norm(g))
    del g, m_plain
    free_card()

    # K7b's inputs of layers 27 and 0 (the first and last backward call of
    # step 1), captured as they pass
    real = fa_ops.flash_attention_bwd_launch
    captured, n_calls = {}, [0]

    def capture(q, k, v, do, **kw):
        i = n_calls[0]
        n_calls[0] += 1
        if i in (0, cfg.num_layers - 1):
            captured[cfg.num_layers - 1 - i] = (
                q.clone(), k.clone(), v.clone(), do.clone(), dict(kw))
        return real(q, k, v, do, **kw)

    step = make_train_step(cfg, settings, backend="cuda")
    losses, gnorms, lrs, step_s = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    fa_ops.flash_attention_bwd_launch = capture
    try:
        for i, b in enumerate(batches):
            if i == 1:
                fa_ops.flash_attention_bwd_launch = real
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
    finally:
        fa_ops.flash_attention_bwd_launch = real
    launches = dict(_ext.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    profiled = train_step_profile(step, state, batches[-1])
    L = cfg.num_layers
    want = dict.fromkeys(launches, 0) | {
        "flash_attention": 2 * L * TRAIN_STEPS,
        "flash_attention_bwd": L * TRAIN_STEPS}
    gates = [
        (launches == want, f"path_lm_train: launches {launches} != {want}"),
        (all(x == x and abs(x) < float("inf") for x in losses),
         f"path_lm_train: a loss is not finite: {losses}"),
        (losses[-1] < losses[0],
         f"path_lm_train: the loss did not fall: {losses}"),
        (abs(losses[0] - loss_plain) <= TRAIN_LOSS_TOL,
         f"path_lm_train: step 1 loss {losses[0]} against interpret's "
         f"{loss_plain}"),
        (abs(gnorms[0] - gnorm_plain) <= TRAIN_GNORM_TOL * gnorm_plain,
         f"path_lm_train: step 1 gradient norm {gnorms[0]} against "
         f"interpret's {gnorm_plain}"),
        (sorted(captured) == [0, L - 1],
         f"path_lm_train: captured layers {sorted(captured)}")]
    del state, batches[1:]
    free_card()

    # K7b on the path's own inputs, layers 0 and 27
    blocks = {}
    for layer, (q, k, v, do, kw) in sorted(captured.items()):
        blocks[f"layer{layer}"] = k7b_against_plain(
            q, k, v, do, "bfloat16", f"path_lm_train layer {layer}", **kw)
    del captured
    free_card()

    # the same model at 4 layers in f32 against interpret
    cfg4 = dataclasses.replace(cfg, num_layers=TRAIN_F32_LAYERS)
    params = init_params(cfg4, generator=torch.Generator(device=dev)
                         .manual_seed(TRAIN_SEED), device=dev,
                         dtype=torch.float32)
    b4 = {k: v[:TRAIN_F32_B] for k, v in batches[0].items()}
    loss_k, g_k = f32_grads(params, cfg4, b4, "cuda")
    loss_p, g_p = f32_grads(params, cfg4, b4, "interpret")
    f32_worst = 0.0
    for a, w in zip(g_k, g_p):
        f32_worst = max(f32_worst, max_abs(a, w) / max(
            float(w.abs().max()), 1e-30))
    gates.append((f32_worst <= TRAIN_F32_TOL,
                  f"path_lm_train f32 4 layers: a gradient {f32_worst} of "
                  "its largest from interpret's"))
    del params, g_k, g_p
    free_card()

    tokens = TRAIN_B * TRAIN_S
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    shape = ShapeConfig("path_lm_train", TRAIN_S, TRAIN_B, "train")
    emit({"phase": "path_lm_train", "arch": TRAIN_ARCH,
          "params": cfg.param_count(), "batch": [TRAIN_B, TRAIN_S],
          "steps": TRAIN_STEPS, "settings": TRAIN_SETTINGS,
          "held_gb_before": held_gb, "init_s": init_s, "state_gb": state_gb,
          "losses": losses, "grad_norms": gnorms, "lrs": lrs,
          "step_ms": [x * 1e3 for x in step_s],
          "steady_step_ms": steady * 1e3,
          "tok_per_s": tokens / steady,
          "model_tflop_per_s": model_flops(cfg, shape) / steady / 1e12,
          "peak_gb": peak_gb, "launches": {k: n for k, n in
                                           launches.items() if n},
          "profiled_step": profiled,
          "step1_interpret": {"loss": loss_plain, "grad_norm": gnorm_plain},
          "block_k7b": blocks, "f32_layers": TRAIN_F32_LAYERS,
          "f32_loss": [loss_k, loss_p], "f32_grad_err": f32_worst,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return launches


def path_lm_restart(dev):
    """Restart on the card through ``RestartManager``: the 4-layer smoke
    config of ``TRAIN_ARCH``, ``RESTART_STEPS`` steps straight, then a run
    checkpointing every ``RESTART_EVERY`` steps that stops there, a fresh
    manager that restores (each leaf's crc32 checked) and replays the
    rest.  Gates: the replayed params within ``RESTART_TOL`` of each
    leaf's largest value of the uninterrupted run's; the checkpoint
    restored onto the CPU equal bit for bit to the one on the card.  ->
    the launch counts of the three runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenDataset
    from repro_torch.ft import RestartManager
    from repro_torch.kernels import _ext
    from repro_torch.train import (
        TrainSettings,
        init_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    cfg = get_smoke_config(TRAIN_ARCH)
    data = TokenDataset(cfg.vocab_size, RESTART_S, TRAIN_B, seed=0)
    step_fn = make_train_step(cfg, TrainSettings(
        peak_lr=1e-3, warmup=2, total_steps=RESTART_STEPS), backend="cuda")

    def fresh():
        return init_train_state(cfg, generator=torch.Generator(
            device=dev).manual_seed(TRAIN_SEED), device=dev)

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(s).items()}

    _ext.reset_launches()
    state = fresh()
    for s in range(RESTART_STEPS):
        state, _ = step_fn(state, batch_fn(s))
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt_restart_", dir=root)
    try:
        st2, end = RestartManager(d, save_every=RESTART_EVERY).run(
            fresh(), step_fn, batch_fn, num_steps=RESTART_EVERY)
        del st2                                          # the crash
        mgr = RestartManager(d, save_every=RESTART_EVERY)
        st3, start = mgr.maybe_restore(fresh())
        on_cpu, _ = restore_checkpoint(d, st3, start, device="cpu")
        cpu_same = all(torch.equal(a.cpu(), b) for a, b in
                       zip(_leaves(st3), _leaves(on_cpu)))
        st3, end = mgr.run(st3, step_fn, batch_fn, num_steps=RESTART_STEPS,
                           start_step=start)
        last = latest_step(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    err = 0.0
    for a, b in zip(_leaves(st3["params"]), _leaves(state["params"])):
        err = max(err, max_abs(a, b) / max(float(b.abs().max()), 1e-30))
    emit({"phase": "path_lm_restart", "arch": cfg.name,
          "steps": RESTART_STEPS, "save_every": RESTART_EVERY,
          "restored_step": start, "last_checkpoint": last,
          "param_err": err, "tol": RESTART_TOL, "cpu_restore_equal": cpu_same,
          "launches": {k: n for k, n in launches.items() if n},
          "seconds": time.perf_counter() - t0})
    check(start == RESTART_EVERY and end == RESTART_STEPS
          and last == RESTART_STEPS,
          f"path_lm_restart: restored {start}, ended {end}, latest {last}")
    check(cpu_same, "path_lm_restart: the CPU restore differs")
    check(err <= RESTART_TOL, f"path_lm_restart: replayed params {err} of "
          "max|p| from the uninterrupted run")
    return launches


# ------------------------------------------ slice 20: the launchers

# path_launch: Qwen3-1.7B at every published width and depth through the
# port's launchers, as a user runs them.  Training: 3 steps of 4 x 1,024
# (the launcher's settings: peak lr 3e-3, warmup max(5, steps // 10),
# total = steps, block remat, AdamW on f32 master weights); serving: 8
# requests of 16 prompt and 16 new tokens in 4 slots, max_seq 128
LAUNCH_TRAIN_ARGV = ["--arch", "qwen3-1.7b", "--full", "--steps", "3",
                     "--batch", "4", "--seq", "1024", "--log-every", "1"]
LAUNCH_SERVE_ARGV = ["--arch", "qwen3-1.7b", "--full", "--requests", "8",
                     "--prompt-len", "16", "--max-new", "16", "--slots",
                     "4", "--max-seq", "128"]
LAUNCH_KEYS = {"arch", "steps", "first_loss", "final_loss", "wall_s"}


def path_launch(dev):
    """The launchers on the card: ``launch.train.main`` and
    ``launch.serve.main`` with ``LAUNCH_TRAIN_ARGV`` / ``LAUNCH_SERVE_ARGV``
    (the card by default), the launch counts set to 0 just before each and
    read just after.  Gates, training: every loss finite, the returned
    dict's keys the reference launcher's, K7 2 x 28 launches a step (the
    forward and the remat's recompute) and K7b 28, nothing else; the three
    losses those of the same steps run by hand through ``make_train_step``
    on a state from the same generator and the same ``TokenDataset``
    batches (equal bit for bit expected: K7b is deterministic; the
    embedding's backward accumulates with atomics, so within
    ``TRAIN_LOSS_TOL``, with the equality reported).  Serving: every
    request served with 16 tokens, the tokens those of a ``ServeEngine``
    fed the same seeded params and requests directly, K7 28 x (prefill +
    decode calls) launches, nothing else.  -> the launchers' launch
    counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import _ext
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import (
        TrainSettings,
        cast_for_compute,
        init_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    held_gb = free_card()
    cfg = get_config("qwen3-1.7b")
    L = cfg.num_layers
    gates = []

    # training through the launcher
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    t = time.perf_counter()
    out = launch_train.main(LAUNCH_TRAIN_ARGV, on_step=lambda s, m: (
        losses.append(float(m["loss"]))))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches = dict(_ext.LAUNCHES)
    train_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    free_card()
    steps = len(losses)
    want = dict.fromkeys(train_launches, 0) | {
        "flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps}
    gates += [
        (set(out) == LAUNCH_KEYS and out["steps"] == steps == 3,
         f"path_launch train: returned {out}, {steps} losses"),
        (all(x == x and abs(x) < float("inf") for x in losses),
         f"path_launch train: a loss is not finite: {losses}"),
        (train_launches == want,
         f"path_launch train: launches {train_launches} != {want}")]

    # the same steps by hand
    settings = TrainSettings(peak_lr=3e-3, warmup=max(5, steps // 10),
                             total_steps=steps, remat=True)
    state = init_train_state(cfg, generator=torch.Generator(dev).manual_seed(
        0), device=dev)
    step = make_train_step(cfg, settings)
    data = TokenDataset(cfg.vocab_size, 1024, 4, seed=0)
    by_hand = []
    for i in range(steps):
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in data.batch_at(i).items()})
        by_hand.append(float(m["loss"]))
    del state, step
    free_card()
    loss_diff = max(abs(a - b) for a, b in zip(losses, by_hand))
    gates.append((loss_diff <= TRAIN_LOSS_TOL,
                  f"path_launch train: losses {losses} against by hand "
                  f"{by_hand}"))

    # serving through the launcher, then the same params and requests
    # straight into a ServeEngine
    served = []
    _ext.reset_launches()
    t = time.perf_counter()
    stats = launch_serve.main(LAUNCH_SERVE_ARGV, requests_out=served)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    serve_launches = dict(_ext.LAUNCHES)
    free_card()
    n_req, slots, new = 8, 4, 16
    calls = -(-n_req // slots) * (1 + new)
    want = dict.fromkeys(serve_launches, 0) | {"flash_attention": L * calls}
    params = cast_for_compute(init_train_state(
        cfg, generator=torch.Generator(dev).manual_seed(0),
        device=dev)["params"])
    free_card()
    direct = launch_serve.make_requests(cfg, n_req, 16, new, 0)
    engine = ServeEngine(cfg, params, batch_slots=slots, max_seq=128,
                         device=dev)
    for r in direct:
        engine.submit(r)
    engine.run(max_steps=n_req * new + 64)
    del engine, params
    free_card()
    same = [a.out == b.out for a, b in zip(served, direct)]
    gates += [
        (len(served) == n_req and all(r.done and len(r.out) == new
                                      for r in served),
         f"path_launch serve: {[(r.rid, len(r.out)) for r in served]}"),
        (len(same) == n_req and all(same),
         f"path_launch serve: tokens differ from the direct engine's "
         f"in requests {[i for i, ok in enumerate(same) if not ok]}"),
        (serve_launches == want,
         f"path_launch serve: launches {serve_launches} != {want}")]

    launches = {k: train_launches.get(k, 0) + serve_launches.get(k, 0)
                for k in set(train_launches) | set(serve_launches)}
    emit({"phase": "path_launch", "arch": cfg.name,
          "held_gb_before": held_gb,
          "train": {"argv": LAUNCH_TRAIN_ARGV, "returned": out,
                    "losses": losses, "by_hand": by_hand,
                    "bit_equal": losses == by_hand, "max_diff": loss_diff,
                    "seconds": train_s, "peak_gb": train_peak_gb,
                    "launches": {k: n for k, n in train_launches.items()
                                 if n}},
          "serve": {"argv": LAUNCH_SERVE_ARGV, "stats": stats,
                    "tokens": [r.out for r in served],
                    "prefill_calls": -(-n_req // slots),
                    "decode_calls": -(-n_req // slots) * new,
                    "seconds": serve_s,
                    "launches": {k: n for k, n in serve_launches.items()
                                 if n}},
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return launches


# ------------------------------------ slice 18: hybrid training (K8b)

# K8b's two kernels, as the profiler names them: the backward walk (x in
# bf16 or f32) and the fixed-order sum of its partials; and K8's forward
# under autograd, the instance that checkpoints h for it
K8B_NAMES = ("selective_scan_bwd_kernel<{N}, {xbf}>",
             "selective_scan_bwd_sum_kernel")
K8_CKPT_INSTANCE = "selective_scan_ckpt_kernel<{N}, {xbf}>"
# K8b against each plain version: every output within K8B_TOL of the
# plain output's largest value plus twice the two plain versions' own
# distance on the same inputs (the reverse recurrence summed over whole
# steps against K8b's schedule written out: 1-3e-7 of the largest value
# on the CPU tests' shapes, more where a sum runs over 4,096 steps or
# 16,384 channels).  A bf16 dx also within one bf16 step (2^-8) of each
# value: a last-bit difference of its f32 sum can round it either way.
K8B_TOL = 1e-5
# name, B, S, di, N, x dtype, h0 (random or zero), dh_final (random or
# zero): the training shape as the Jamba path gives it (x bf16, zero h0,
# no dh_final), the same width with x f32, random h0 and dh_final at S =
# 256, N = 8 at a ragged S (100, not a multiple of its 8-step chunk)
# and di (1,000, not a multiple of its 128-channel block), S = 1 at N = 8
# and at the full width, S = 83 (not a multiple of 4) at N = 16, and the
# smoke width
K8B_CASES = (
    ("train_1024", 4, 1024, 16384, 16, "bfloat16", "zero", "zero"),
    ("s256_x_f32", 2, 256, 16384, 16, "float32", "random", "random"),
    ("n8_ragged", 2, 100, 1000, 8, "bfloat16", "random", "zero"),
    ("n8_s1", 3, 1, 384, 8, "float32", "zero", "random"),
    ("s1_full_width", 4, 1, 16384, 16, "bfloat16", "random", "random"),
    ("n16_s83", 1, 83, 200, 16, "float32", "random", "random"),
    ("smoke_n8", 2, 64, 128, 8, "float32", "zero", "zero"),
)
K8B_TIMED_LAUNCHES = 10

# path_hybrid_train: Jamba-1.5-Large at every published width, one
# 8-layer period as path_hybrid_serve takes it, experts 0-1 of 16 (the
# one-card stand-in for the reference's "ep" sharding), the config's
# bf16 master weights and Adafactor, bf16 compute, block remat,
# TokenDataset(seed=0) batches of HYT_B x 1,024, TRAIN_SETTINGS.  The
# period holds 11.4 B parameters (22.8 GB in bf16) and as much again in
# gradients, then the remat period's activations: the peak at 4 x 1,024
# tokens was 66.8 GB (an H100 80GB HBM3 at 700 W), under the card's 80
# GB with room, so the batch is 4.  Each step takes another batch, and
# the step-to-step swings of the loss (up to 0.055) are twice its fall
# over 8 steps (0.027), so the fall is read on batch 0, evaluated again
# after the steps (fixed_batch_before)
HYT_B, HYT_S, HYT_STEPS, HYT_EXPERTS = 4, 1024, 8, range(0, 2)
# the layers whose K8b inputs (taken from step 1) are held against the
# plain versions, and the attention layer whose K7b inputs are
HYT_K8B_LAYERS, HYT_K7B_LAYER = (0, 6), 4
# step 1 against backend="interpret" (reported, not gated): the plain
# scan holds [B, S, di, N] f32 tensors and a state a step under autograd
# (over 10 GB a mixer at the full batch), so the three runs take row 0's
# first 256 tokens on the same params
HYT_CMP_S = 256
# the f32 gradient check: the Jamba smoke config (2 periods, N = 8, D =
# 16, 4 experts) at B = 2, S = 64; every gradient within TRAIN_F32_TOL of
# its largest value plus the plain path's own spread: interpret on the
# card against interpret on the CPU, each leaf's distance relative to its
# largest value, the largest over the leaves (one leaf's own spread can
# be near 0 where the seeded model moves another's by 1e-3)
HYT_F32_B, HYT_F32_S = 2, 64


def k8b_inputs(dev, B, S, di, N, x_dtype, h0_kind, dh_kind, seed):
    """``disc_inputs`` plus dy N(0, 1) [B, S, di] and dh_final N(0, 1) (or
    None); h0 zero where ``h0_kind`` says so."""
    import torch

    dt, A, Bm, Cm, x, h0 = disc_inputs(dev, B, S, di, N,
                                       getattr(torch, x_dtype), seed)
    if h0_kind == "zero":
        h0 = torch.zeros_like(h0)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    dy = torch.randn((B, S, di), generator=g, device=dev)
    dh = (torch.randn((B, di, N), generator=g, device=dev)
          if dh_kind == "random" else None)
    return dt, A, Bm, Cm, x, h0, dy, dh


def k8b_bound(B, S, di, N, x_itemsize, dh_final: bool):
    """The gradient's operands once over the HBM rate: dt, dy and ddt
    (f32) and x and dx (in x's dtype) [B, S, di], Bm, C, dBm and dC [B,
    S, N], A and dA [di, N], h0, dh0 and dh_final [B, di, N] (K8's
    checkpoints are K8b's own and not counted); 21 f32 operations per
    (t, d, n) over 67 TFLOP/s (the chunk's forward again: 7 with expf
    counted as one; the walk: 14)."""
    moved = (B * S * di * (12 + 2 * x_itemsize) + 16 * B * S * N
             + 8 * di * N + 4 * B * di * N * (3 if dh_final else 2))
    return bound(moved, 21.0 * B * S * di * N)


def k8b_against_plain(dt, A, Bm, Cm, x, h0, dy, dh, what: str,
                      ckpt=None) -> dict:
    """K8b twice on the same inputs (bit-identical) against
    ``selective_scan_bwd_ref`` and ``selective_scan_bwd_chunked_ref``:
    each output within ``K8B_TOL`` of the plain output's largest value
    plus twice the two plain versions' distance (a bf16 dx also within
    2^-8 of each value).  ``ckpt``: the checkpoints K8's forward wrote
    (None: K8's checkpointing launch writes them here); either way equal
    bit for bit to ``scan_checkpoints``.  -> {"err": worst over the
    outputs relative to the largest plain value, "err_chunked": the same
    against the chunked version, "pair": the plain versions' distance,
    "bits_differ_chunked": values where K8b and the chunked version
    differ}."""
    import torch

    from repro_torch.kernels.selective_scan import (
        bwd_chunk,
        scan_checkpoints,
        selective_scan_bwd_chunked_ref,
        selective_scan_bwd_launch,
        selective_scan_bwd_ref,
        selective_scan_discretized_launch,
    )

    if ckpt is None:
        _, _, ckpt = selective_scan_discretized_launch(
            dt, A, Bm, Cm, x, h0, checkpoint=True)
    want_ckpt = scan_checkpoints(dt, A, Bm, x, h0, bwd_chunk(A.shape[1]))
    n_ck = int((ckpt != want_ckpt).sum())
    del want_ckpt
    got = selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt, dy, dh,
                                    need_dh0=True)
    again = selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt, dy, dh,
                                      need_dh0=True)
    torch.cuda.synchronize()
    check(n_ck == 0, f"K8b {what}: K8's checkpoints differ from the plain "
          f"forward's in {n_ck} values")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K8b {what}: two calls differ")
    del again
    plain = selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy, dh)
    chunked = selective_scan_bwd_chunked_ref(dt, A, Bm, Cm, x, h0, dy, dh)
    out = {"err": 0.0, "err_chunked": 0.0, "pair": 0.0,
           "bits_differ_chunked": 0, "by_output": {}}
    names = ("ddt", "dA", "dBm", "dCm", "dx", "dh0")
    for name, g, p, c in zip(names, got, plain, chunked):
        check(g.dtype == p.dtype and g.shape == p.shape,
              f"K8b {what}: {name} {g.dtype} {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"K8b {what}: {name} not finite")
        scale = max(float(p.float().abs().max()), 1e-30)
        pair = max_abs(p, c) / scale
        errs = {}
        for key, w in (("err", p), ("err_chunked", c)):
            d = (g.float() - w.float()).abs()
            allow = (K8B_TOL + 2 * pair) * scale
            if g.dtype == torch.bfloat16:
                allow = allow + 2.0 ** -8 * w.float().abs()
            errs[key] = float(d.max()) / scale
            check(bool((d <= allow).all()),
                  f"K8b {what}: {name} {errs[key]} of max|plain| {scale} "
                  f"from the {key.replace('err', 'plain')} version (the "
                  f"plain pair {pair})")
            out[key] = max(out[key], errs[key])
        n_bits = int((g != c).sum())
        out["pair"] = max(out["pair"], pair)
        out["bits_differ_chunked"] += n_bits
        out["by_output"][name] = {**errs, "pair": pair, "scale": scale,
                                  "bits_differ_chunked": n_bits}
    return out


def kernels_check_scan_bwd(dev):
    """K8b at every case of ``K8B_CASES`` through ``k8b_against_plain``
    (K8's checkpointing launch first).  -> {"selective_scan_bwd": the
    worst error relative to the plain output's largest value}."""
    rows, worst = [], 0.0
    for i, (name, B, S, di, N, xdt, h0k, dhk) in enumerate(K8B_CASES):
        args = k8b_inputs(dev, B, S, di, N, xdt, h0k, dhk, 300 + i)
        e = k8b_against_plain(*args, name)
        worst = max(worst, e["err"], e["err_chunked"])
        rows.append({"case": name, "shape": [B, S, di, N], "x_dtype": xdt,
                     "h0": h0k, "dh_final": dhk, "deterministic": True, **e})
        del args
        free_card()
    emit({"phase": "kernels_check_scan_bwd", "tol": K8B_TOL, "cases": rows})
    return {"selective_scan_bwd": worst}


def kernels_time_scan_bwd(dev):
    """K8b at every case of ``K8B_CASES``: wrapper ms (CUDA events over
    ``K8B_TIMED_LAUNCHES`` calls), device ms (profiler: its two kernels
    summed per call) and the bound; at the training shape also the plain
    version's ms (``selective_scan_bwd_ref``) and K8's forward under
    autograd (the checkpointing instance's device ms) beside the serving
    instance's on the same inputs.  No single PyTorch call computes the
    scan's gradient, so ``library_ms`` is null.  -> {case: numbers}."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd_launch,
        selective_scan_bwd_ref,
        selective_scan_discretized_launch,
    )

    out = {}
    for i, (name, B, S, di, N, xdt, h0k, dhk) in enumerate(K8B_CASES):
        dt, A, Bm, Cm, x, h0, dy, dh = k8b_inputs(dev, B, S, di, N, xdt, h0k,
                                                  dhk, 400 + i)
        xbf = "true" if xdt == "bfloat16" else "false"
        _, _, ckpt = selective_scan_discretized_launch(
            dt, A, Bm, Cm, x, h0, checkpoint=True)
        k8b = lambda: selective_scan_bwd_launch(  # noqa: E731
            dt, A, Bm, Cm, x, ckpt, dy, dh, need_dh0=h0k == "random")
        names = [n.format(N=N, xbf=xbf) for n in K8B_NAMES]
        calls = {names[0]: k8b, names[1]: lambda: None}
        for _ in range(3):
            seen = kernel_device_ms(calls, K8B_TIMED_LAUNCHES)
            if all(seen[n]["events"] == K8B_TIMED_LAUNCHES for n in names):
                break
        parts = {n: seen[n]["ms"] for n in names}
        row = dict(
            ms=time_ms(k8b, K8B_TIMED_LAUNCHES),
            kernel_ms=(sum(parts.values()) if None not in parts.values()
                       else None),
            kernel_parts_ms=parts,
            kernel_events={n: seen[n]["events"] for n in names},
            plain_ms=None, library_ms=None,
            bound=k8b_bound(B, S, di, N, x.element_size(), dh is not None),
            shape=[B, S, di, N], x_dtype=xdt, kernels=names)
        if name == "train_1024":
            row["plain_ms"] = time_ms(lambda: selective_scan_bwd_ref(
                dt, A, Bm, Cm, x, h0, dy, dh), 1)
            fwd = {K8_CKPT_INSTANCE.format(N=N, xbf=xbf):
                   lambda: selective_scan_discretized_launch(
                       dt, A, Bm, Cm, x, h0, checkpoint=True),
                   K8_DISC_INSTANCE.format(N=N, xbf=xbf):
                   lambda: selective_scan_discretized_launch(
                       dt, A, Bm, Cm, x, h0)}
            seen = kernel_device_ms(fwd, K8B_TIMED_LAUNCHES)
            row["forward_kernel_ms"] = {k: v["ms"] for k, v in seen.items()}
        out[name] = row
        del dt, A, Bm, Cm, x, h0, dy, dh, ckpt
        free_card()
    emit({"phase": "kernels_time_scan_bwd", **out,
          "nvidia_smi": nvidia_smi()})
    return out


def hybrid_step1(cfg, params, batch, settings) -> dict:
    """Step 1's loss and gradient norm on ``params`` and ``batch``,
    nothing updated: on K7 / K7b and K8 / K8b (``backend="cuda"``), on the
    plain attention and scan (``"interpret"``), and the plain path
    against itself: ``"interpret"`` again with the other of PyTorch's two
    BLAS back ends (cuBLAS, cuBLASLt) taking the matrix products (the
    same function, its products tiled and summed by other kernels;
    "reordered_same_bits" says whether that moved anything)."""
    import torch

    from repro_torch.optim import global_norm
    from repro_torch.train import make_grad_fn

    out = {}
    blas = torch.backends.cuda.preferred_blas_library()
    other = "cublas" if "lt" in str(blas).lower() else "cublaslt"
    for name, backend, lib in (("cuda", "cuda", blas),
                               ("interpret", "interpret", blas),
                               ("interpret_reordered", "interpret", other)):
        torch.backends.cuda.preferred_blas_library(lib)
        try:
            m, g = make_grad_fn(cfg, settings, backend=backend,
                                experts=HYT_EXPERTS)(params, batch)
            out[name] = {"loss": float(m["loss"]),
                         "grad_norm": float(global_norm(g))}
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
        del g, m
        free_card()
    out["blas"] = [str(blas), other]
    out["reordered_same_bits"] = out["interpret"] == out["interpret_reordered"]
    return out


def fixed_batch_loss(cfg, params, batch, backend: str) -> float:
    """The loss ``make_grad_fn`` takes (``forward`` on the bf16 compute
    copy, MoE layers holding ``HYT_EXPERTS``) on ``params`` and
    ``batch``, under no_grad: nothing saved, nothing updated."""
    import torch

    from repro_torch.models.transformer import forward
    from repro_torch.train.losses import total_loss
    from repro_torch.train.step import cast_for_compute

    with torch.no_grad():
        logits, _, aux = forward(cast_for_compute(params), cfg,
                                 tokens=batch["tokens"], mode="train",
                                 backend=backend, experts=HYT_EXPERTS)
        loss = float(total_loss(logits, batch["targets"], aux)[0])
    del logits, aux
    free_card()
    return loss


def fixed_batch_before(cfg, params, batch) -> dict:
    """Batch 0's loss on the initial ``params`` (``fixed_batch_loss``) on
    ``"cuda"``, and the rounding spread a fall must clear: the largest
    distance between that loss and the same function's other roundings
    on the same batch (``"interpret"``, and ``"interpret"`` with the
    other of PyTorch's two BLAS back ends taking the products)."""
    import torch

    blas = torch.backends.cuda.preferred_blas_library()
    other = "cublas" if "lt" in str(blas).lower() else "cublaslt"
    out = {"cuda": fixed_batch_loss(cfg, params, batch, "cuda"),
           "interpret": fixed_batch_loss(cfg, params, batch, "interpret")}
    torch.backends.cuda.preferred_blas_library(other)
    try:
        out["interpret_reordered"] = fixed_batch_loss(cfg, params, batch,
                                                      "interpret")
    finally:
        torch.backends.cuda.preferred_blas_library(blas)
    losses = list(out.values())
    out["spread"] = max(losses) - min(losses)
    return out


def path_hybrid_train(dev):
    """Hybrid training on the card: Jamba-1.5-Large at every published
    width (d_model 8,192, d_inner 16,384, d_state 16, 64 query heads over
    8, d_ff 24,576, vocab 65,536, 16 experts top-2), one 8-layer period
    (7 Mamba mixers, attention at slot 4, MoE at slots 0, 2, 4, 6) with
    experts ``HYT_EXPERTS``, ``init_train_state`` (the config's bf16
    master weights and Adafactor, seeded), bf16 compute, block remat,
    ``TRAIN_SETTINGS``, ``backend="cuda"``: ``HYT_STEPS`` steps of
    ``make_train_step`` on
    ``TokenDataset(seed=0)`` batches of ``HYT_B`` x 1,024, the launch
    counts set to 0 just before them and read just after (K8 7 x 2 a
    step: the forward and the remat's recompute, each writing its
    checkpoints; K8b 7; K7 2; K7b 1).  Gates: every loss finite, the
    last below the first; batch 0's loss evaluated again after the steps
    below its loss before them by more than that loss's rounding spread
    (``fixed_batch_before``: the batches differ from step to step, so
    only a fixed batch reads a fall as learning); K8b on layers 0's and
    6's own inputs of step 1
    (dt, A, Bm, Cm, x, the checkpoints and dy as they passed) against
    both plain versions (``k8b_against_plain``); K7b on layer 4's own
    q, k, v and dO within ``K7_TOL``; the launch counts; the Jamba smoke
    config in f32 (``HYT_F32_B`` x ``HYT_F32_S``), every gradient on
    ``"cuda"`` (K7b's f32 instance, K8b with x in f32) within
    ``TRAIN_F32_TOL`` of its largest value plus the plain path's own
    relative spread (``"interpret"`` on the card against
    ``"interpret"`` on the CPU, the largest over the leaves).
    Reported: step 1's loss and gradient norm on K7 / K8 against
    ``"interpret"`` and the plain path against itself (``hybrid_step1``,
    row 0's first ``HYT_CMP_S`` tokens), step ms, tok/s, peak GB and one
    more step under the profiler.  -> the main run's launch counts."""
    import torch

    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import _ext
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.models.registry import init_params, model_flops
    from repro_torch.models.transformer import decoder_layout
    from repro_torch.train import (
        TrainSettings,
        init_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    held_gb = free_card()
    cfg = hybrid_config()
    settings = TrainSettings(**TRAIN_SETTINGS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = init_train_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(HY_SEED), device=dev, experts=HYT_EXPERTS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    params_gb = sum(x.numel() * x.element_size()
                    for x in _leaves(state["params"])) / 1e9
    state_gb = sum(x.numel() * x.element_size() for x in _leaves(state)) / 1e9
    data = TokenDataset(cfg.vocab_size, HYT_S, HYT_B, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch_at(i).items()} for i in range(HYT_STEPS)]
    step1 = hybrid_step1(cfg, state["params"], {
        k: v[:1, :HYT_CMP_S].contiguous() for k, v in batches[0].items()},
        settings)
    fixed = fixed_batch_before(cfg, state["params"], batches[0])

    # K8b's inputs of layers 0 and 6 and K7b's of layer 4, from step 1's
    # backward (the mixers' backward runs last layer first)
    _, slots = decoder_layout(cfg)
    mamba = [i for i, s in enumerate(slots) if s.mixer == "mamba"][::-1]
    real_k8b = ss_ops.selective_scan_bwd_launch
    real_k7b = fa_ops.flash_attention_bwd_launch
    captured, n_k8b = {}, [0]

    def capture_k8b(dt, A, Bm, Cm, x, ckpt, dy, dh=None, **kw):
        layer = mamba[n_k8b[0]]
        n_k8b[0] += 1
        if layer in HYT_K8B_LAYERS:
            captured[layer] = tuple(None if t is None else t.clone()
                                    for t in (dt, A, Bm, Cm, x, ckpt, dy, dh))
        return real_k8b(dt, A, Bm, Cm, x, ckpt, dy, dh, **kw)

    def capture_k7b(q, k, v, do, **kw):
        captured["attn"] = (q.clone(), k.clone(), v.clone(), do.clone(),
                            dict(kw))
        return real_k7b(q, k, v, do, **kw)

    step = make_train_step(cfg, settings, backend="cuda",
                           experts=HYT_EXPERTS)
    losses, gnorms, step_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    ss_ops.selective_scan_bwd_launch = capture_k8b
    fa_ops.flash_attention_bwd_launch = capture_k7b
    try:
        for i, b in enumerate(batches):
            if i == 1:
                ss_ops.selective_scan_bwd_launch = real_k8b
                fa_ops.flash_attention_bwd_launch = real_k7b
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    finally:
        ss_ops.selective_scan_bwd_launch = real_k8b
        fa_ops.flash_attention_bwd_launch = real_k7b
    launches = dict(_ext.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fixed["after"] = fixed_batch_loss(cfg, state["params"], batches[0],
                                      "cuda")
    profiled = train_step_profile(step, state, batches[-1])
    n_m = len(mamba)
    want = dict.fromkeys(launches, 0) | {
        "selective_scan_discretized": 2 * n_m * HYT_STEPS,
        "selective_scan_bwd": n_m * HYT_STEPS,
        "flash_attention": 2 * HYT_STEPS,
        "flash_attention_bwd": HYT_STEPS}
    gates = [
        (launches == want,
         f"path_hybrid_train: launches {launches} != {want}"),
        (all(x == x and abs(x) < float("inf") for x in losses),
         f"path_hybrid_train: a loss is not finite: {losses}"),
        (losses[-1] < losses[0],
         f"path_hybrid_train: the loss did not fall: {losses}"),
        (fixed["after"] < fixed["cuda"] - fixed["spread"],
         f"path_hybrid_train: batch 0's loss did not fall by more than "
         f"its rounding spread: {fixed}"),
        (sorted(k for k in captured if k != "attn") == list(HYT_K8B_LAYERS)
         and "attn" in captured,
         f"path_hybrid_train: captured {sorted(map(str, captured))}")]
    del state, batches
    free_card()

    blocks = {}
    for layer in HYT_K8B_LAYERS:
        if layer not in captured:
            continue
        dt, A, Bm, Cm, x, ckpt, dy, dh = captured.pop(layer)
        blocks[f"k8b_layer{layer}"] = k8b_against_plain(
            dt, A, Bm, Cm, x, torch.zeros(
                (dt.shape[0], dt.shape[2], A.shape[1]), device=dev),
            dy, dh, f"path_hybrid_train layer {layer}", ckpt=ckpt)
        del dt, A, Bm, Cm, x, ckpt, dy, dh
        free_card()
    if "attn" in captured:
        q, k, v, do, kw = captured.pop("attn")
        blocks[f"k7b_layer{HYT_K7B_LAYER}"] = k7b_against_plain(
            q, k, v, do, "bfloat16",
            f"path_hybrid_train layer {HYT_K7B_LAYER}", **kw)
        del q, k, v, do
    free_card()

    # the smoke config in f32: K7b's f32 instance and K8b with x in f32
    scfg = get_smoke_config(HY_ARCH)
    params = init_params(scfg, generator=torch.Generator(device=dev)
                         .manual_seed(HY_SEED), device=dev,
                         dtype=torch.float32)
    sb = {k: torch.from_numpy(v).to(dev) for k, v in TokenDataset(
        scfg.vocab_size, HYT_F32_S, HYT_F32_B, seed=1).batch_at(0).items()}
    _ext.reset_launches()
    loss_k, g_k = f32_grads(params, scfg, sb, "cuda")
    f32_launches = dict(_ext.LAUNCHES)
    loss_p, g_p = f32_grads(params, scfg, sb, "interpret")
    loss_c, g_c = f32_grads(tree_map(lambda x: x.cpu(), params), scfg,
                            {k: v.cpu() for k, v in sb.items()}, "interpret")
    scales = [max(float(w.abs().max()), 1e-30) for w in g_p]
    f32_spread = max(max_abs(w, c.to(dev)) / sc
                     for w, c, sc in zip(g_p, g_c, scales))
    f32_worst = max(max_abs(a, w) / sc for a, w, sc in zip(g_k, g_p, scales))
    gates += [
        (f32_worst <= TRAIN_F32_TOL + f32_spread,
         f"path_hybrid_train f32 smoke: a gradient {f32_worst} of "
         f"its largest from interpret's (plain spread {f32_spread})"),
        (f32_launches["flash_attention_bwd"] > 0
         and f32_launches["selective_scan_bwd"] > 0,
         f"path_hybrid_train f32 smoke: launches {f32_launches}")]
    del params, g_k, g_p, g_c
    free_card()

    tokens = HYT_B * HYT_S
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    shape = ShapeConfig("path_hybrid_train", HYT_S, HYT_B, "train")
    emit({"phase": "path_hybrid_train", "arch": HY_ARCH,
          "layers": cfg.num_layers, "experts": [HYT_EXPERTS.start,
                                                HYT_EXPERTS.stop - 1],
          "params_gb": params_gb, "state_gb": state_gb,
          "batch": [HYT_B, HYT_S], "steps": HYT_STEPS,
          "settings": TRAIN_SETTINGS, "held_gb_before": held_gb,
          "init_s": init_s, "losses": losses, "grad_norms": gnorms,
          "step_ms": [x * 1e3 for x in step_s],
          "steady_step_ms": steady * 1e3, "tok_per_s": tokens / steady,
          "model_tflop_per_s": model_flops(cfg, shape) / steady / 1e12,
          "peak_gb": peak_gb,
          "launches": {k: n for k, n in launches.items() if n},
          "profiled_step": profiled,
          "step1_cmp": {"tokens": [1, HYT_CMP_S], **step1},
          "fixed_batch": fixed,
          "blocks": blocks,
          "f32_smoke": {"batch": [HYT_F32_B, HYT_F32_S],
                        "loss": [loss_k, loss_p, loss_c],
                        "grad_err": f32_worst, "plain_spread": f32_spread,
                        "launches": {k: n for k, n in f32_launches.items()
                                     if n}},
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})
    for ok, msg in gates:
        check(ok, msg)
    return launches


def grad_refusals(dev):
    """K8's TPU interface and K9 have no backward on the card (no path of
    either package trains through them; the Mamba block trains through
    K8's discretizing entry and K8b): called under autograd with CUDA
    tensors they raise (nothing launches); without grad they run."""
    import torch

    from repro_torch.kernels import _ext
    from repro_torch.kernels.binarized_gemm import binarized_gemm
    from repro_torch.kernels.selective_scan import selective_scan

    B, S, di, N = 1, 8, 64, 16
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(s, generator=g, device=dev)  # noqa: E731
    Cm, h0 = r(B, S, N), r(B, di, N)
    dA, dBx = r(B, S, di, N), r(B, S, di, N)
    xb, wb = r(37, 200) - 0.5, r(200, 45) - 0.5
    calls = {"selective_scan": lambda: selective_scan(dA, dBx, Cm, h0),
             "binarized_gemm": lambda: binarized_gemm(xb, wb)}
    leaves = {"selective_scan": dA, "binarized_gemm": xb}
    _ext.reset_launches()
    refused = {}
    for name, call in calls.items():
        leaves[name].requires_grad_(True)
        try:
            call()
            refused[name] = False
        except NotImplementedError:
            refused[name] = True
        leaves[name].requires_grad_(False)
    torch.cuda.synchronize()
    silent = dict(_ext.LAUNCHES)
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    emit({"phase": "grad_refusals", "refused": refused,
          "launched_under_grad": {k: n for k, n in silent.items() if n}})
    check(all(refused.values()), f"grad_refusals: {refused}")
    check(not any(silent.values()), f"grad_refusals: launched {silent}")
    check(all(_ext.LAUNCHES[k] == 1 for k in calls),
          f"grad_refusals: without grad {dict(_ext.LAUNCHES)}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------- main

KERNELS = (
    ("fused_flow_serve", "src/repro_torch/kernels/fused_flow/csrc/fused_flow.cu",
     "src/repro/kernels/fused_flow/kernel.py:338"),
    ("flow_update", "src/repro_torch/kernels/flow_update/csrc/flow_update.cu",
     "src/repro/kernels/flow_update/kernel.py:235"),
    ("fused_mlp_classify", "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu",
     "src/repro/kernels/fused_mlp/kernel.py:71"),
    ("mat_lut_classify", "src/repro_torch/kernels/mat_lut/csrc/mat_lut.cu",
     "src/repro/kernels/mat_lut/kernel.py:41"),
    ("fused_mlp", "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu",
     "src/repro/kernels/fused_mlp/kernel.py:59"),
    ("fused_dag", "src/repro_torch/kernels/fused_mlp/csrc/fused_dag.cu",
     "src/repro/kernels/fused_mlp/kernel.py:158"),
    ("flash_attention",
     "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:35"),
    # K7b, K7's backward: the TPU kernel has none (the JAX package takes
    # XLA's gradient); it replaces that kernel's part in training
    ("flash_attention_bwd",
     "src/repro_torch/kernels/flash_attention/csrc/flash_backward.cu",
     "src/repro/kernels/flash_attention/kernel.py:35"),
    ("selective_scan",
     "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
     "src/repro/kernels/selective_scan/kernel.py:35"),
    ("selective_scan_discretized",
     "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
     "src/repro/kernels/selective_scan/kernel.py:35"),
    # K8b, the discretizing entry's backward: the TPU kernel has none (the
    # JAX package takes XLA's gradient of repro/models/ssm.py:58-89); it
    # replaces that kernel's part in training
    ("selective_scan_bwd",
     "src/repro_torch/kernels/selective_scan/csrc/selective_scan_bwd.cu",
     "src/repro/kernels/selective_scan/kernel.py:35"),
    ("binarized_gemm",
     "src/repro_torch/kernels/binarized_gemm/csrc/binarized_gemm.cu",
     "src/repro/kernels/binarized_gemm/kernel.py:29"),
)
# the timing row of each kernel in the kernels line (K5, K6: the AD
# widths; the full-width rows ride along under "full_width")
MAIN_CONFIG = {"fused_mlp": "ad", "fused_dag": "ad>tc"}
FULL_CONFIG = {"fused_mlp": "ad_full", "fused_dag": "ad_full>tc",
               "fused_mlp_classify": "ad_full"}


def refuse(reason: str) -> int:
    """Exit code 2 with the reason on both streams (a caller that keeps
    only standard output still sees why)."""
    print(f"chip_smoke: {reason}", flush=True)
    print(f"chip_smoke: {reason}", file=sys.stderr)
    return 2


def main() -> int:
    try:
        import torch
    except ImportError:
        return refuse("torch is not installed")
    if not torch.cuda.is_available():
        return refuse("torch.cuda.is_available() is False")
    try:
        from repro_torch.kernels import _ext
    except ImportError as e:
        return refuse(f"the port is missing (no src/repro_torch beside "
                      f"this script): {e!r}")

    from repro_torch.core import chaining
    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    t = time.perf_counter()
    _ext.extension()
    emit({"phase": "build", "nvidia_smi": smi,
          "build_s": time.perf_counter() - t,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    try:
        err, times = kernel_phase(dev)
        for k, v in kernels_check_dag(dev).items():
            err[k] = max(err.get(k, 0.0), v)
        dag_times = dag_timing(dev)
        err.update(kernels_check_multi(dev))
        multi_times = multi_timing(dev)
        chain_times = chain_timing(dev)
        err.update(kernels_check_lm(dev))
        lm_times = kernels_time_lm(dev)
        err.update(kernels_check_lm_bwd(dev))
        bwd_times = kernels_time_lm_bwd(dev)
        err.update(kernels_check_scan(dev))
        scan_times = kernels_time_scan(dev)
        err.update(kernels_check_scan_bwd(dev))
        scan_bwd_times = kernels_time_scan_bwd(dev)
        err.update(kernels_check_bgemm(dev))
        bgemm_times = kernels_time_bgemm(dev)
        split_action_table_phase(dev)
        mitigated_counts = []
        by_path = {
            "path_flow_ddos": path_phase(dev, "path_flow_ddos", S_KERNEL,
                                         (256, 512), (True, False),
                                         N_PACKETS, repeats=3),
            "path_mat_fused": mat_path_phase(dev, "path_mat_fused", False),
            "path_mitigate_fused": mat_path_phase(
                dev, "path_mitigate_fused", True, counts=mitigated_counts),
            "attack_defense": attack_defense_phase(dev),
            "path_dag": path_dag_phase(dev),
        }
        by_path["path_two_table"], _ = path_two_table_phase(dev)
        by_path["path_sharded"] = path_sharded(dev)
        by_path["path_lm_serve"] = path_lm_serve(dev)
        by_path["path_hybrid_serve"] = path_hybrid_serve(dev)
        by_path["path_moe_serve"] = path_moe_serve(dev)
        by_path["path_mixtral_serve"] = path_mixtral_serve(dev)
        by_path["path_vlm_serve"] = path_vlm_serve(dev)
        by_path["path_encdec_serve"] = path_encdec_serve(dev)
        by_path["path_xlstm_serve"] = path_xlstm_serve(dev)
        by_path["path_lm_train"] = path_lm_train(dev)
        by_path["path_lm_restart"] = path_lm_restart(dev)
        by_path["path_launch"] = path_launch(dev)
        by_path["path_hybrid_train"] = path_hybrid_train(dev)
        grad_refusals(dev)
        by_path["path_generate"] = path_generate(dev)
        by_path["path_online"] = path_online(dev)
        by_path["path_fusion"] = path_fusion(dev)
        launches = {k: sum(p[k] for p in by_path.values())
                    for k, _, _ in KERNELS}
        for path, want in (("path_flow_ddos", ("fused_flow_serve",
                                               "flow_update",
                                               "fused_mlp_classify")),
                           ("path_mat_fused", ("fused_flow_serve",
                                               "flow_update",
                                               "mat_lut_classify")),
                           ("path_mitigate_fused", ("fused_flow_serve",
                                                    "flow_update",
                                                    "mat_lut_classify")),
                           ("attack_defense", ("fused_flow_serve",
                                               "flow_update",
                                               "fused_mlp_classify")),
                           ("path_dag", ("fused_dag", "fused_mlp_classify",
                                         "fused_mlp")),
                           ("path_two_table", ("fused_flow_serve",
                                               "flow_update",
                                               "fused_mlp_classify",
                                               "mat_lut_classify")),
                           ("path_sharded", ("fused_flow_serve",
                                             "flow_update",
                                             "fused_mlp_classify",
                                             "mat_lut_classify",
                                             "fused_dag")),
                           ("path_lm_serve", ("flash_attention",)),
                           ("path_lm_train", ("flash_attention",
                                              "flash_attention_bwd")),
                           ("path_lm_restart", ("flash_attention",
                                                "flash_attention_bwd")),
                           ("path_launch", ("flash_attention",
                                            "flash_attention_bwd")),
                           ("path_hybrid_train", (
                               "selective_scan_discretized",
                               "selective_scan_bwd", "flash_attention",
                               "flash_attention_bwd")),
                           ("path_moe_serve", ("flash_attention",)),
                           ("path_mixtral_serve", ("flash_attention",)),
                           ("path_vlm_serve", ("flash_attention",)),
                           ("path_encdec_serve", ("flash_attention",)),
                           ("path_hybrid_serve", (
                               "selective_scan_discretized",
                               "flash_attention")),
                           ("path_generate", ("fused_mlp_classify",
                                              "mat_lut_classify")),
                           ("path_online", ("fused_flow_serve",
                                            "flow_update",
                                            "fused_mlp_classify")),
                           ("path_fusion", ("fused_mlp_classify",))):
            for k in want:
                check(by_path[path][k] > 0, f"{k} never launched on {path}")
        telemetry_phase(dev, mitigated_counts)
        path_phase(dev, "path_max_slots", 1 << 16, (512,), (True,),
                   N_PACKETS, repeats=3)
        stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS,
                                     seed=STREAM_SEED)
        for name, stages in (
                ("flow-ddos", flow_ddos_stages(S_KERNEL)),
                ("mitigate-fused", mat_fused_stages(S_KERNEL, True)),
                ("two-table", two_table("mlp"))):
            profile_phase(dev, name, StatefulPipeline(
                stages, backend="cuda", device=dev.type),
                lambda: stream.chunks(512), len(traffic.COLUMNS))
        X = ad_test_set()
        profile_phase(dev, "dag ad>tc (fused)", chaining.compile_dag(
            dag_nodes()["ad>tc"], dag_models(dev)[0], backend="cuda",
            device=dev.type), lambda: (X[i:i + DAG_CHUNK] for i in range(
                0, len(X), DAG_CHUNK)), AD_FEATURES)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    kernels = []
    times["flash_attention"] = lm_times["prefill_512"]
    times["flash_attention_bwd"] = bwd_times["qwen3_train_1024"]
    times["selective_scan"] = scan_times["tpu_interface"]["prefill_512"]
    times["selective_scan_discretized"] = \
        scan_times["discretized"]["prefill_512"]
    times["selective_scan_bwd"] = scan_bwd_times["train_1024"]
    times["binarized_gemm"] = bgemm_times["4096^3"]
    for name, source, replaces in KERNELS:
        tm = (dag_times[name][MAIN_CONFIG[name]] if name in MAIN_CONFIG
              else times[name])
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": tm["ms"],
            "kernel_ms": tm["kernel_ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1],
            "library_ms": tm.get("library_ms"),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
        }
        if name == "flash_attention":
            entry["kernels"] = sorted({n for m in lm_times.values()
                                       for n in m["kernels"]})
            entry["shapes"] = {
                cfg: {"shape": m["shape"], "q_offset": m["q_offset"],
                      "causal": m["causal"], "window": m["window"],
                      "skv": m["skv"],
                      "dtype": m["dtype"], "kernels": m["kernels"],
                      "ms": m["ms"], "kernel_ms": m["kernel_ms"],
                      "kernel_parts_ms": m["kernel_parts_ms"],
                      "plain_ms": m["plain_ms"], "library_ms": m["library_ms"],
                      "library_kernel_ms": m["library_kernel_ms"],
                      "bound_ms": m["bound"][0], "bound_by": m["bound"][1]}
                for cfg, m in lm_times.items()}
        if name == "flash_attention_bwd":
            entry["kernels"] = sorted({n for m in bwd_times.values()
                                       for n in m["kernels"]})
            entry["library_kernel_ms"] = tm["library_kernel_ms"]
            entry["shapes"] = {
                cfg: {k: m[k] for k in (
                    "shape", "dtype", "causal", "window", "q_offset", "skv",
                    "kernels", "ms", "kernel_ms", "kernel_parts_ms",
                    "plain_ms", "library_ms", "library_kernel_ms")}
                | {"bound_ms": m["bound"][0], "bound_by": m["bound"][1]}
                for cfg, m in bwd_times.items()}
        if name in ("selective_scan", "selective_scan_discretized"):
            rows = scan_times["tpu_interface" if name == "selective_scan"
                              else "discretized"]
            entry["instances"] = sorted({m["kernel"] for m in rows.values()})
            entry["shapes"] = {
                cfg: {"shape": m["shape"], "kernel": m["kernel"],
                      "ms": m["ms"], "kernel_ms": m["kernel_ms"],
                      "plain_ms": m["plain_ms"], "library_ms": None,
                      "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                      **{k: m[k] for k in ("x_dtype", "before_kernel_ms",
                                           "before_eager_kernel_ms",
                                           "before_k8_kernel_ms") if k in m}}
                for cfg, m in rows.items()}
        if name == "selective_scan_bwd":
            entry["kernels"] = sorted({n for m in scan_bwd_times.values()
                                       for n in m["kernels"]})
            entry["forward_kernel_ms"] = tm["forward_kernel_ms"]
            entry["shapes"] = {
                cfg: {k: m[k] for k in (
                    "shape", "x_dtype", "kernels", "ms", "kernel_ms",
                    "kernel_parts_ms", "plain_ms", "library_ms")}
                | {"bound_ms": m["bound"][0], "bound_by": m["bound"][1]}
                for cfg, m in scan_bwd_times.items()}
        if name == "mat_lut_classify":
            entry["kernels"] = sorted({tm["kernel"]} | {
                m["kernel"] for m in tm["tofino"].values()})
            entry["launch_floor"] = tm["launch_floor"]
            entry["shapes"] = {
                cfg: {k: m[k] for k in ("kernel", "B", "features", "edges",
                                        "classes", "ms", "kernel_ms",
                                        "plain_ms")}
                | {"bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                   "library_ms": None}
                for cfg, m in {"mat_fused": tm,
                               **{f"tofino_{b}": v for b, v in
                                  tm["tofino"].items()}}.items()}
        if name == "binarized_gemm":
            entry["kernels"] = [n.format(x="float", w="float")
                                for n in K9_NAMES]
            entry["library"] = bgemm_times["4096^3"]["library"]
            entry["shapes"] = {
                cfg: {"shape": m["shape"], "ms": m["ms"],
                      "kernel_ms": m["kernel_ms"],
                      "kernel_parts_ms": m["kernel_parts_ms"],
                      "plain_ms": m["plain_ms"],
                      "library_ms": m["library_ms"],
                      "library_layouts_ms": m["library_layouts_ms"],
                      "bound_ms": m["bound"][0], "bound_by": m["bound"][1]}
                for cfg, m in bgemm_times.items()}
        if name in FULL_CONFIG:
            by_b = {B: dag_times[name][FULL_CONFIG[name] + (
                    "" if B == DAG_TIME_B else f"@{B}")]
                    for B in DAG_TIME_FULL}
            full = by_b[DAG_TIME_B]
            entry["full_width"] = {
                "widths": full["widths"], "kernel": full["kernel"],
                "ms": full["ms"], "kernel_ms": full["kernel_ms"],
                "plain_ms": full["plain_ms"], "bound_ms": full["bound"][0],
                "bound_by": full["bound"][1],
                "by_batch": {B: {"ms": m["ms"], "kernel_ms": m["kernel_ms"],
                                 "plain_ms": m["plain_ms"],
                                 "bound_ms": m["bound"][0],
                                 "bound_by": m["bound"][1]}
                             for B, m in by_b.items()}}
        if name in ("fused_flow_serve", "flow_update"):
            entry["chain"] = {
                "device_ms_by_depth": {
                    d: v[name] for d, v in chain_times["device_ms"].items()},
                "ns_per_step": chain_times["ns_per_step"][name]}
        if name == "fused_flow_serve":
            entry["modes"] = {
                mode: {"ms": m["ms"], "kernel_ms": m["kernel_ms"],
                       "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                       "bound_by": m["bound"][1],
                       **({"k3_kernel_ms": m["k3_kernel_ms"]}
                          if "k3_kernel_ms" in m else {})}
                for mode, m in tm["modes"].items()}
            entry["multi_table"] = {
                "max_abs_err": err["fused_flow_serve_multi"],
                "launches": by_path["path_two_table"][name],
                "modes": {mode: {
                    "ms": m["ms"], "kernel_ms": m["kernel_ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                    "bound_by": m["bound"][1], "max_chain": m["max_chain"]}
                    for mode, m in multi_times.items()}}
        kernels.append(entry)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
