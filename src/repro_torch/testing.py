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

``ragged=True`` marks the last quarter of a batch and a few holes as
padding (``valid == 0``).  Every batch also carries a few ``-0.0`` EWMA
values and packets whose two histogram columns coincide.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.flowstate.registers import FlowStateSpec, hash_slot_np

PATTERNS = ("one_hot_flow", "all_distinct", "same_slot", "mixed")

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


def pattern_keys(rng, pattern: str, n: int, n_slots: int) -> np.ndarray:
    if pattern == "one_hot_flow":
        hot = rng.random(n) < 0.9
        return np.where(hot, 7, rng.integers(0, 200, n)).astype(np.int32)
    if pattern == "all_distinct":
        return (np.arange(n) + 1).astype(np.int32)
    if pattern == "same_slot":
        return same_slot_keys(n, n_slots)
    if pattern == "mixed":
        return rng.integers(0, 9, n).astype(np.int32)
    raise KeyError(f"pattern must be one of {PATTERNS}")


def flow_batch(spec: FlowStateSpec, pattern: str, B: int, seed: int, *,
               ragged: bool = False) -> dict:
    """Seeded operands for one register update, as numpy: pkt_keys [B]
    int32, upd [B, C+E] f32, bins [B, H] int32, valid [B] int32."""
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
    if H > 1:                 # a column hit twice in one packet
        dup = rng.random(B) < 0.05
        bins[dup, 1] = bins[dup, 0]
    valid = np.ones(B, np.int32)
    if ragged:
        valid[3 * B // 4:] = 0
        valid[rng.integers(0, 3 * B // 4, 5)] = 0
    return {"pkt_keys": pattern_keys(rng, pattern, B, spec.n_slots),
            "upd": upd, "bins": bins, "valid": valid}


def random_mlp(widths, seed: int):
    """Seeded f32 (weights, biases) numpy lists for an MLP of ``widths``."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in widths[1:]]
    return ws, bs


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
                       margin: float = MARGIN) -> tuple[int, int]:
    """-> (rows whose verdict differs from the reference argmax although
    the top-two margin exceeds ``margin``, rows within the margin)."""
    ref = np.argmax(ref_logits, 1)
    top = np.sort(ref_logits, 1)
    gap = (top[:, -1] - top[:, -2] if ref_logits.shape[1] > 1
           else np.full(len(ref), np.inf))
    close = gap <= margin
    bad = (np.asarray(verdicts) != ref) & ~close
    return int(bad.sum()), int(close.sum())
