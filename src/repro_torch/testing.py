"""Shared test inputs and checks for the port: the collision patterns the
slot segmentation must survive, seeded MLPs, the plain whole-stream
reference and the verdict margin rule.  The CPU tests and the card phase
of ``chip_smoke.py`` use the same cases.

Patterns (``PATTERNS``):

  ``one_hot_flow``  ~90% of packets on one flow: one deep chain
  ``all_distinct``  every key unique: chains of length one
  ``same_slot``     distinct keys that all hash to one slot: an eviction
                    chain (keys picked with equal ``hash_slot``)
  ``mixed``         a few keys, heavy collisions
  ``slot_runs``     runs of repeated keys (1-12 packets each) drawn from
                    six distinct keys that all hash to one slot: eviction
                    chains in which flows also repeat, so action-table
                    rows cross their threshold mid-chain and are evicted

The colliding patterns collide over ``key_slots`` slots (default: the
flow table's); keys that share a slot in the larger of two power-of-two
tables share one in the smaller too, so passing the larger slot count
makes them collide in the flow table and the action table alike.

Chunk-edge patterns (``EDGE_PATTERNS``, not in ``PATTERNS``), for the
kernels' slot-chain walk, which stages a chain ``RT_CHAIN_CHUNK`` (32)
packets at a time:

  ``chain_edges``   chains of exactly 1, 31, 32, 33, 33, 64 and 64
                    packets in distinct slots, the second 33 and 64 with
                    an eviction at packet 32 (a chunk's first packet), and
                    the rest of the batch as one chain with evictions at
                    packets 32, 96 and 128; arrival order interleaves the
                    chains at random
  ``one_chain``     the whole batch on one slot, with evictions at packets
                    32, 40, 96, 256 and 480

Both also carry ``-0.0`` counter increments.

``ragged=True`` marks the last quarter of a batch and a few holes as
padding (``valid == 0``).  Every batch also carries a few ``-0.0`` EWMA
values and packets whose two histogram columns coincide.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.flowstate.registers import FlowStateSpec, hash_slot_np

PATTERNS = ("one_hot_flow", "all_distinct", "same_slot", "mixed",
            "slot_runs")

EDGE_PATTERNS = ("chain_edges", "one_chain")
# chain lengths of "chain_edges" and the packets of each at which the
# key changes; the rest of the batch forms one more chain
EDGE_CHAINS = ((1, ()), (31, ()), (32, ()), (33, ()), (33, (32,)),
               (64, ()), (64, (32,)))
EDGE_REST_SWITCHES = (32, 96, 128)
ONE_CHAIN_SWITCHES = (32, 40, 96, 256, 480)

# verdicts may differ only on rows whose top-two logit margin is within
# this (the MLP's f32 summation order differs between engines)
MARGIN = 1e-4


def same_slot_keys(n: int, n_slots: int) -> np.ndarray:
    """n distinct keys that all hash to one slot."""
    cand = np.arange(1, 1024 * n_slots, dtype=np.int32)
    slots = hash_slot_np(cand, n_slots)
    hit = cand[slots == slots[0]]
    if len(hit) < n:
        raise ValueError("widen the candidate scan")
    return hit[:n]


def slot_groups(n_groups: int, per: int, n_slots: int,
                min_slots: int) -> list:
    """``n_groups`` lists of ``per`` distinct keys: the keys of a list
    share a slot of ``n_slots``, and no two lists share a slot of
    ``min_slots`` (the smaller of the tables the keys go to)."""
    cand = np.arange(1, 64 * n_slots, dtype=np.int32)
    slots = hash_slot_np(cand, n_slots)
    groups, taken = [], set()
    for s in dict.fromkeys(slots.tolist()):
        if s % min_slots in taken:
            continue
        keys = cand[slots == s][:per]
        if len(keys) == per:
            groups.append(keys)
            taken.add(s % min_slots)
            if len(groups) == n_groups:
                return groups
    raise ValueError("widen the candidate scan")


def _switching(pool, length: int, switches) -> np.ndarray:
    """``length`` keys from ``pool``, the next key from packet ``s`` on
    for each s in ``switches``."""
    idx = np.zeros(length, np.int64)
    for s in switches:
        idx[s:] += 1
    return pool[idx % len(pool)]


def edge_keys(rng, pattern: str, n: int, n_slots: int,
              min_slots: int) -> np.ndarray:
    """Keys of the chunk-edge patterns (``EDGE_PATTERNS``)."""
    if pattern == "one_chain":
        pool = slot_groups(1, 3, n_slots, min_slots)[0]
        return _switching(pool, n, [s for s in ONE_CHAIN_SWITCHES if s < n])
    chains, total = [], 0
    for length, sw in EDGE_CHAINS:
        if total + length > n:
            break
        chains.append((length, sw))
        total += length
    if n > total:
        chains.append((n - total, [s for s in EDGE_REST_SWITCHES
                                   if s < n - total]))
    pools = slot_groups(len(chains), 2, n_slots, min_slots)
    labels = rng.permutation(np.repeat(np.arange(len(chains)),
                                       [c[0] for c in chains]))
    keys = np.empty(n, np.int32)
    for c, ((length, sw), pool) in enumerate(zip(chains, pools)):
        keys[labels == c] = _switching(pool, length, sw)
    return keys


def pattern_keys(rng, pattern: str, n: int, n_slots: int,
                 min_slots: int | None = None) -> np.ndarray:
    if pattern in EDGE_PATTERNS:
        return edge_keys(rng, pattern, n, n_slots, min_slots or n_slots)
    if pattern == "one_hot_flow":
        hot = rng.random(n) < 0.9
        return np.where(hot, 7, rng.integers(0, 200, n)).astype(np.int32)
    if pattern == "all_distinct":
        return (np.arange(n) + 1).astype(np.int32)
    if pattern == "same_slot":
        return same_slot_keys(n, n_slots)
    if pattern == "mixed":
        return rng.integers(0, 9, n).astype(np.int32)
    if pattern == "slot_runs":
        pool = same_slot_keys(6, n_slots)
        runs = [np.full(rng.integers(1, 13), rng.choice(pool))
                for _ in range(n)]
        return np.concatenate(runs)[:n].astype(np.int32)
    raise KeyError(f"pattern must be one of {PATTERNS}")


def flow_batch(spec: FlowStateSpec, pattern: str, B: int, seed: int, *,
               ragged: bool = False, key_slots: int | None = None,
               dup_bins: bool = True) -> dict:
    """Seeded operands for one register update, as numpy: pkt_keys [B]
    int32, upd [B, C+E] f32, bins [B, H] int32, valid [B] int32.  Keys of
    the colliding patterns collide over ``key_slots`` slots (default
    ``spec.n_slots``).  With ``dup_bins`` about 5 % of packets hit one
    histogram column twice; without it every bins column hits its own
    histogram or nothing, as RegisterUpdate makes them."""
    rng = np.random.default_rng(seed)
    C, E = spec.n_counters, spec.n_ewma
    upd = np.empty((B, C + E), np.float32)
    upd[:, 0] = 1.0                                   # packet count
    upd[:, 1:C] = rng.integers(40, 1500, (B, C - 1))
    upd[:, C:] = rng.random((B, E)) * rng.choice([1.0, 1500.0], E)
    upd[:, C:][rng.random((B, E)) < 0.05] = -0.0     # signed zeros
    H = max(len(spec.hist_sizes), 1)
    bins = np.full((B, H), -1, np.int32)
    for j, (off, size) in enumerate(zip(spec.hist_offsets, spec.hist_sizes)):
        col = rng.integers(off, off + size, B)
        bins[:, j] = np.where(rng.random(B) < 0.9, col, -1)
    if H > 1 and dup_bins:    # a column hit twice in one packet
        dup = rng.random(B) < 0.05
        bins[dup, 1] = bins[dup, 0]
    if pattern in EDGE_PATTERNS:
        upd[:, 1:C][rng.random((B, C - 1)) < 0.05] = -0.0
    valid = np.ones(B, np.int32)
    if ragged:
        valid[3 * B // 4:] = 0
        valid[rng.integers(0, 3 * B // 4, 5)] = 0
    slots = spec.n_slots if key_slots is None else key_slots
    return {"pkt_keys": pattern_keys(rng, pattern, B, slots,
                                     min(slots, spec.n_slots)),
            "upd": upd, "bins": bins, "valid": valid}


def random_mlp(widths, seed: int):
    """Seeded f32 (weights, biases) numpy lists for an MLP of ``widths``."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in widths[1:]]
    return ws, bs


def he_mlp(widths, seed: int):
    """Seeded f32 (weights, biases) numpy lists for a ReLU MLP with He
    scaling (std sqrt(2 / fan_in)) and biases 0.1 * N(0, 1): activations
    keep their scale through deep stacks, so a [7, 128 x 10, 2] model
    still separates its classes."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in widths[1:]]
    return ws, bs


AD_WIDTHS = (7, 16, 8, 2)
AD_FULL_WIDTHS = (7,) + (128,) * 10 + (2,)


def ad_pipelines(device, seed: int = 0) -> dict:
    """The stateless models of the AD DAG (7 features, as
    ``netdata.make_ad_dataset(features=7)``), seeded, as
    ``stageir.StagePipeline`` s on ``device`` (interpret): "ad" a DNN
    ``AD_WIDTHS`` + argmax, "tc" an SVM (Dense [7, 2] + argmax), "cl" a
    k=4 centroid classifier + LabelMap [0, 1, 0, 1], "ad_full" the
    deepest DNN the design space emits, ``AD_FULL_WIDTHS`` + argmax."""
    from repro_torch.core import stageir

    rng = np.random.default_rng(seed + 100)
    svm_w, svm_b = he_mlp((7, 2), seed + 1)
    pipes = {
        "ad": [stageir.FusedMLP(*he_mlp(AD_WIDTHS, seed)),
               stageir.Reduce("argmax")],
        "tc": [stageir.Dense(svm_w[0], svm_b[0]), stageir.Reduce("argmax")],
        "cl": [stageir.CentroidDistance(
                   rng.normal(size=(4, 7)).astype(np.float32)),
               stageir.Reduce("argmin"),
               stageir.LabelMap(np.asarray([0, 1, 0, 1], np.int32))],
        "ad_full": [stageir.FusedMLP(*he_mlp(AD_FULL_WIDTHS, seed + 2)),
                    stageir.Reduce("argmax")],
    }
    return {k: stageir.StagePipeline(v, device=device)
            for k, v in pipes.items()}


def leaf_margin_rows(pipelines, X, margin: float = MARGIN) -> np.ndarray:
    """Rows on which any MLP or Dense classifier among ``pipelines`` has
    its top-two logits within ``margin`` (plain f32 logits on the CPU).
    A Seq gate carries one leaf's flip downstream, so DAG parity excludes
    every such row."""
    from repro_torch.core import stageir

    x = torch.as_tensor(np.asarray(X, np.float32))
    close = np.zeros(len(x), bool)
    for p in pipelines:
        st = stageir.unfuse_pipeline_stages(p.stages)
        if len(st) >= 2 and isinstance(st[-1], stageir.Reduce) \
                and isinstance(st[-2], (stageir.FusedMLP, stageir.Dense)):
            lg = stageir.apply_stages(st[:-1], x, plain=True).numpy()
            top = np.sort(lg, 1)
            close |= (top[:, -1] - top[:, -2]) <= margin
    return close


def readout_moments(prefix, packets: np.ndarray, device="cpu"):
    """Mean and standard deviation (+1e-6) of the readout rows that
    ``prefix`` ([FlowKey, RegisterUpdate, WindowStats]) gives a packet
    stream, walked once from an empty table -> (mu, sd) f32 numpy.  The
    attack/defense detector folds them into its first layer
    (``traffic.fold_input_standardization``), as the reference's
    ``build_pipeline`` folds its training set's moments."""
    from repro_torch.flowstate.registers import init_state
    from repro_torch.kernels.flow_update import flow_update_ref

    fk, ru, ws = prefix
    spec = ru.spec
    st = init_state(spec, device)
    x = torch.as_tensor(packets, device=device)
    upd, bins = ru.prepare(x)
    valid = torch.ones(x.shape[0], dtype=torch.int32, device=device)
    _, _, feats = flow_update_ref(st.keys, st.regs, fk.apply_keys(x), upd,
                                  bins, valid, n_counters=spec.n_counters,
                                  n_ewma=spec.n_ewma, alpha=spec.ewma_alpha)
    z = ws.apply(feats).cpu().numpy().astype(np.float64)
    return (z.mean(0).astype(np.float32),
            (z.std(0) + 1e-6).astype(np.float32))


def plain_stream(stages, packets: np.ndarray, max_batch: int, device):
    """Walk a whole packet stream through the plain ops only ->
    (keys [S], regs [S, W], logits [N, classes]) as numpy.  The sequential
    reference does not depend on how the stream is batched."""
    from repro_torch.core import stageir
    from repro_torch.flowstate.registers import init_state
    from repro_torch.kernels.flow_update import flow_update_ref
    from repro_torch.kernels.fused_mlp import mlp_ref

    fk, ru, *suffix = stages
    body = stageir.unfuse_pipeline_stages(suffix)
    pre, mlp = body[:-2], body[-2]
    spec = ru.spec
    st = init_state(spec, device)
    keys, regs, logits = st.keys, st.regs, []
    for s in range(0, len(packets), max_batch):
        x = torch.as_tensor(packets[s:s + max_batch], device=device)
        upd, bins = ru.prepare(x)
        valid = torch.ones(x.shape[0], dtype=torch.int32, device=device)
        keys, regs, feats = flow_update_ref(
            keys, regs, fk.apply_keys(x), upd, bins, valid,
            n_counters=spec.n_counters, n_ewma=spec.n_ewma,
            alpha=spec.ewma_alpha)
        z = stageir.apply_stages(pre, feats)
        ws = [torch.as_tensor(w, device=device) for w in mlp.weights]
        bs = [torch.as_tensor(b, device=device) for b in mlp.biases]
        logits.append(mlp_ref(z, ws, bs).cpu().numpy())
    return keys.cpu().numpy(), regs.cpu().numpy(), np.concatenate(logits)


def verdict_mismatches(verdicts: np.ndarray, ref_logits: np.ndarray,
                       margin: float = MARGIN, *, use_min: bool = False,
                       label_map=None) -> tuple[int, int]:
    """-> (rows whose verdict differs from the reference arg-reduce
    (argmin with ``use_min``, then ``label_map``) although the top-two
    margin exceeds ``margin``, rows within the margin)."""
    scores = -np.asarray(ref_logits) if use_min else np.asarray(ref_logits)
    ref = np.argmax(scores, 1)
    if label_map is not None:
        ref = np.asarray(label_map)[ref]
    top = np.sort(scores, 1)
    gap = (top[:, -1] - top[:, -2] if scores.shape[1] > 1
           else np.full(len(ref), np.inf))
    close = gap <= margin
    bad = (np.asarray(verdicts) != ref) & ~close
    return int(bad.sum()), int(close.sum())


def mat_stages(n_in: int, seed: int = 7, *, use_min: bool = False,
               stageir=None):
    """The mat-fused classifier of ``benchmarks/flow_throughput.py:58-80``
    as port stages (or as the stages of ``stageir``, a module with the
    same stage classes): edges [n_in, 7] (feature 0's edges 1..7, for the
    raw packet count), tables [n_in, 8, 4] from ``default_rng(seed)`` and
    the LabelMap [0, 1, 1, 0]."""
    if stageir is None:
        from repro_torch.core import stageir

    rng = np.random.default_rng(seed)
    edges = np.sort(rng.random((n_in, 7)).astype(np.float32), axis=1)
    edges[0] = np.arange(1.0, 8.0, dtype=np.float32)
    tables = rng.random((n_in, 8, 4)).astype(np.float32)
    return [stageir.Quantize(edges), stageir.LUTGather(tables),
            stageir.Reduce("argmin" if use_min else "argmax"),
            stageir.LabelMap(np.asarray([0, 1, 1, 0], np.int32))]


TWO_TABLE_SUFFIXES = ("mlp", "mat", "centroid")


def two_table_stages(stageir, traffic, spec_cls, *, n_slots: int = 2048,
                     port_slots: int = 2048, suffix: str = "mlp",
                     mitigation=None, hidden=(16, 8), seed: int = 0):
    """The two-table configuration as the stages of ``stageir`` (the
    port's or the JAX package's: the classes take the same arguments),
    built with that package's ``traffic`` module and ``FlowStateSpec``
    (``spec_cls``).  Table 0 is the flow-ddos table
    (``traffic.flow_feature_stages``, W = 28); table 1 aggregates per
    destination port: ``FlowStateSpec(port_slots, n_counters=2, n_ewma=1,
    hist_sizes=(16,))`` counting packet length, an EWMA of the
    inter-packet time and a packet-length histogram on the flow-ddos
    edges, W = 19.  Both read out through ``WindowStats("all")``, so the
    classifier takes 47 features: a seeded MLP ``[47, *hidden, 2]``, the
    mat-fused MAT (``mat_stages(47)``) or 4 seeded centroids over 6
    features of both tables (``FeatureSelect``, argmin, LabelMap [0, 1,
    0, 1]).  ``mitigation`` (a ``MitigationSpec``) appends ``Mitigate``."""
    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=n_slots)
    spec2 = spec_cls(n_slots=port_slots, n_counters=2, n_ewma=1,
                     hist_sizes=(16,), ewma_alpha=0.125)
    fk2 = stageir.FlowKey((traffic.COL_PORT,), port_slots)
    ru2 = stageir.RegisterUpdate(
        spec2, counter_cols=(traffic.COL_LEN,),
        ewma_cols=(traffic.COL_IPT,), hist_cols=(traffic.COL_LEN,),
        hist_edges=(np.asarray(ru.hist_edges[0]),))
    ws2 = stageir.WindowStats(spec2, "all")
    n_in = ws.n_out + ws2.n_out
    if suffix == "mlp":
        cls = [stageir.FusedMLP(*random_mlp((n_in, *hidden, 2), seed)),
               stageir.Reduce("argmax")]
    elif suffix == "mat":
        cls = mat_stages(n_in, stageir=stageir)
    elif suffix == "centroid":
        rng = np.random.default_rng(seed + 11)
        idx = np.asarray([0, 2, 5, 28, 30, 31], np.int64)
        cent = (rng.random((4, 6)) * np.asarray([40, 1, 1, 400, 1, 1])
                ).astype(np.float32)
        cls = [stageir.FeatureSelect(idx), stageir.CentroidDistance(cent),
               stageir.Reduce("argmin"),
               stageir.LabelMap(np.asarray([0, 1, 0, 1], np.int32))]
    else:
        raise KeyError(f"suffix must be one of {TWO_TABLE_SUFFIXES}")
    stages = [fk, ru, ws, fk2, ru2, ws2] + cls
    if mitigation is not None:
        stages.append(stageir.Mitigate(mitigation))
    return stages
