"""The action table's policy and its plain versions (counterpart of the
update half of ``repro.flowstate.mitigation``): what K1's mitigation
phase (``kernels/csrc/mitigate_chain.cuh``) is held against.

Layout: stored keys [Sm] int32 (-1 = empty) and rows [Sm, 2] f32
``[hits, since]`` — ``hits`` counts attack verdicts (dropped packets
included), ``since`` counts packets while marked.  Same hash, the same
evict-on-collision / last-writer-wins policy and the same arrival-order
semantics as the detection table.

Two plain versions compute the same update:

  ``mitigate_update``            the sequential walk in arrival order,
                                 on host values: the oracle, what the
                                 ``interpret`` backend and K1's plain
                                 version run;
  ``mitigate_update_segmented``  the same rules as whole-batch tensor
                                 operations on the inputs' device, with
                                 no host copy: what the split ``cuda``
                                 path runs (on the card as a replayed
                                 CUDA graph, ``core.cuda_backend``).

Every table value is an integer-valued f32 below 2^24, so both give the
same bits as the JAX package's f32 scan.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flow_update.ops import segment_batch
from repro_torch.kernels.flow_update.ref import hash_slot

# verdict of a dropped packet: the packet never produced a verdict
MITIGATED = -1

MITIGATION_MODES = ("drop", "rate_limit")

# action-table row layout: [hits, since]
MIT_WIDTH = 2


@dataclasses.dataclass(frozen=True)
class MitigationSpec:
    """Shape and policy of the action table."""

    n_slots: int = 1024
    mode: str = "drop"
    threshold: int = 3
    keep_every: int = 8
    attack_class: int = 1

    def __post_init__(self):
        if self.n_slots < 2 or self.n_slots & (self.n_slots - 1):
            raise ValueError(
                f"n_slots must be a power of two >= 2, got {self.n_slots}")
        if self.mode not in MITIGATION_MODES:
            raise KeyError(
                f"mode must be one of {MITIGATION_MODES}, got {self.mode!r}")
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1")
        if self.keep_every < 2:
            raise ValueError("keep_every must be >= 2 (1 would disable "
                             "rate limiting entirely)")

    @property
    def width(self) -> int:
        """Words per action row ([hits, since])."""
        return MIT_WIDTH

    @property
    def sram_bytes(self) -> int:
        """Stored key + row words per slot."""
        return self.n_slots * (self.width + 1) * 4


def mitigate_update(mit_keys: torch.Tensor, mit_regs: torch.Tensor,
                    pkt_keys: torch.Tensor, verdicts: torch.Tensor,
                    valid: torch.Tensor, *, spec: MitigationSpec):
    """One batched action-table update by the sequential walk ->
    (mit_keys', mit_regs', out_verdicts [B] int32) on the inputs' device;
    the inputs are not written.

    Per packet, in arrival order: a marked slot drops (or rate-limits)
    the packet, whose verdict becomes ``MITIGATED``; an unmarked slot
    passes the verdict through.  Then ``hits`` grows by one for an
    ``attack_class`` verdict and ``since`` counts packets while marked.
    Padding rows (``valid == 0``) never touch the table and keep their
    verdicts.  The walk runs on host values: the batch's control values
    and touched rows come to the host in one copy and go back in one
    scatter."""
    S = int(mit_keys.shape[0])
    dev = mit_keys.device
    B = int(pkt_keys.shape[0])
    vd = verdicts.to(torch.int32)
    if B == 0:
        return mit_keys.clone(), mit_regs.clone(), vd.clone()
    slot_d = hash_slot(pkt_keys.to(torch.int32), S).to(torch.int64)
    # slots, keys, verdicts, valid and the touched rows: every value an
    # integer below 2^24, exact in f64
    host = torch.cat([
        slot_d.to(torch.float64), pkt_keys.to(torch.float64),
        vd.to(torch.float64), valid.to(torch.float64),
        mit_keys[slot_d].to(torch.float64),
        mit_regs[slot_d].to(torch.float64).reshape(-1)]).cpu().tolist()
    slots = [int(v) for v in host[:B]]
    pk = [int(v) for v in host[B:2 * B]]
    vv = [int(v) for v in host[2 * B:3 * B]]
    ok = [v != 0 for v in host[3 * B:4 * B]]
    keys = {s: int(k) for s, k in zip(slots, host[4 * B:5 * B])}
    flat = host[5 * B:]
    rows = {s: (flat[2 * i], flat[2 * i + 1]) for i, s in enumerate(slots)}
    thr, keep = float(spec.threshold), float(spec.keep_every)
    out = list(vv)
    for p, (s, key, v, live) in enumerate(zip(slots, pk, vv, ok)):
        if not live:
            continue
        fresh = keys[s] != key                 # evict-on-collision
        hits0, since0 = (0.0, 0.0) if fresh else rows[s]
        marked0 = hits0 >= thr
        if spec.mode == "drop":
            drop = marked0
        else:                                  # pass every keep_every-th
            drop = marked0 and since0 % keep != 0.0
        if drop:
            out[p] = MITIGATED
        rows[s] = (hits0 + (1.0 if v == spec.attack_class else 0.0),
                   since0 + 1.0 if marked0 else 0.0)
        keys[s] = key
    touched = sorted(keys)
    idx = torch.tensor(touched, dtype=torch.int64, device=dev)
    k2 = mit_keys.clone()
    r2 = mit_regs.clone()
    k2[idx] = torch.tensor([keys[s] for s in touched], dtype=torch.int32,
                           device=dev)
    r2[idx] = torch.tensor([rows[s] for s in touched], dtype=torch.float32,
                           device=dev)
    return k2, r2, torch.tensor(out, dtype=torch.int32, device=dev)


def mitigate_update_segmented(mit_keys: torch.Tensor,
                              mit_regs: torch.Tensor,
                              pkt_keys: torch.Tensor,
                              verdicts: torch.Tensor, valid: torch.Tensor,
                              *, spec: MitigationSpec):
    """``mitigate_update``'s result from whole-batch tensor operations on
    the inputs' device, with no host copy or sync; the inputs are not
    written.

    The batch is stable-sorted by action slot (``segment_batch``, padding
    last).  Within a slot's chain, a run of packets of one flow starts
    from the stored row when it is the chain's first run and its key is
    the stored key, else from zeros (evict-on-collision).  ``hits`` only
    grows along a run, so a run is marked from its first marked packet
    on: before a packet, ``hits`` is the run's start plus the attack
    verdicts before it in the run, and ``since`` of a marked packet is
    the run's start ``since`` (kept only when the run starts marked) plus
    the marked packets before it in the run.  Sums run in f64 over
    integer values, so they are exact."""
    S = int(mit_keys.shape[0])
    dev = mit_keys.device
    B = int(pkt_keys.shape[0])
    vd = verdicts.to(torch.int32)
    if B == 0:
        return mit_keys.clone(), mit_regs.clone(), vd.clone()
    f64 = torch.float64
    slot = hash_slot(pkt_keys.to(torch.int32), S).to(torch.int64)
    seg = segment_batch(slot, valid, S)
    order = seg.order.to(torch.int64)
    pos = torch.arange(B, dtype=torch.int64, device=dev)
    live = (valid != 0)[order]
    sl = slot[order]
    kk = pkt_keys.to(torch.int64)[order]
    vv = vd[order]
    first = live & (seg.rank == 0)             # first packet of its chain
    new_run = first.clone()
    new_run[1:] |= kk[1:] != kk[:-1]
    head = torch.cummax(torch.where(new_run, pos, 0), 0).values
    stored = mit_regs.to(f64)[sl]
    cont = first & (mit_keys.to(torch.int64)[sl] == kk)
    h0 = torch.where(cont, stored[:, 0], 0.0)[head]
    s0 = torch.where(cont, stored[:, 1], 0.0)[head]

    def before_in_run(x):
        """Sum of ``x`` over the run's earlier packets."""
        c = torch.cumsum(x, 0) - x
        return c - c[head]

    atk = (live & (vv == spec.attack_class)).to(f64)
    hits = h0 + before_in_run(atk)
    marked = live & (hits >= spec.threshold)
    since = torch.where(marked, torch.where(marked[head], s0, 0.0)
                        + before_in_run(marked.to(f64)), 0.0)
    drop = marked if spec.mode == "drop" else \
        marked & (torch.remainder(since, spec.keep_every) != 0)
    out = torch.where(drop, MITIGATED, vv)[seg.inv.to(torch.int64)]

    # each chain's last packet writes its slot; every other sorted
    # position writes a spare row of its own, sliced off after
    last = live.clone()
    last[:-1] &= first[1:] | ~live[1:]
    tgt = torch.where(last, sl, S + pos)
    rows = torch.stack([hits + atk, torch.where(marked, since + 1.0, 0.0)],
                       1).to(torch.float32)
    k2 = torch.cat([mit_keys, mit_keys.new_full((B,), -1)]).index_copy_(
        0, tgt, kk.to(torch.int32))[:S]
    r2 = torch.cat([mit_regs, mit_regs.new_zeros((B, MIT_WIDTH))]
                   ).index_copy_(0, tgt, rows)[:S]
    return k2, r2, out


def mitigate_update_staged(mit_keys: torch.Tensor, mit_regs: torch.Tensor,
                           pkt_keys: torch.Tensor, verdicts: torch.Tensor,
                           valid: torch.Tensor, *, spec: MitigationSpec,
                           chunk: int | None = None):
    """``mitigate_update``'s result computed the way K1's mitigation
    phase walks (``kernels/csrc/mitigate_chain.cuh``): the plain form of
    its decomposition.  Each action segment goes in chunks of ``chunk``
    steps (default ``RT_CHAIN_CHUNK``): the chunk's eviction flags compare
    adjacent keys, its first step against the key carried across the
    edge, and its attack flags are read at once; the chain keeps only the
    (hits, since) recurrence, recording each step's state before the
    packet; after the chunk every step's drop rule is applied at once.
    f32 values, as the kernel's; segments walked side by side; the inputs
    are not written."""
    from repro_torch.kernels._ext import header_define

    chunk = header_define("RT_CHAIN_CHUNK") if chunk is None else chunk
    S = int(mit_keys.shape[0])
    dev = mit_keys.device
    f32 = torch.float32
    keys_out = mit_keys.to(torch.int32).clone()
    regs_out = mit_regs.to(f32).clone()
    out = verdicts.to(torch.int32).clone()
    if int(pkt_keys.shape[0]) == 0:
        return keys_out, regs_out, out
    seg = segment_batch(hash_slot(pkt_keys.to(torch.int32), S), valid, S)
    live = seg.seg_len > 0
    slot = seg.seg_slot[live].to(torch.int64)
    first = seg.seg_first[live].to(torch.int64)
    length = seg.seg_len[live].to(torch.int64)
    order = seg.order.to(torch.int64)
    pk = pkt_keys.to(torch.int32)
    stored = keys_out[slot]
    hits = regs_out[slot, 0]
    since = regs_out[slot, 1]
    zero = torch.zeros_like(hits)
    thr = torch.tensor(float(spec.threshold), dtype=f32, device=dev)
    keep = torch.tensor(float(spec.keep_every), dtype=f32, device=dev)
    steps = torch.arange(chunk, dtype=torch.int64, device=dev)
    for r0 in range(0, int(length.max()) if len(length) else 0, chunk):
        r = r0 + steps
        on = r[None, :] < length[:, None]                   # [K, chunk]
        p = order[torch.where(on, first[:, None] + r[None, :], 0)]
        key = pk[p]
        prev = torch.cat([stored[:, None], key[:, :-1]], 1)
        fresh = on & (key != prev)
        attack = on & (out[p] == spec.attack_class)
        marked = torch.zeros_like(on)
        s0s = torch.zeros(on.shape, dtype=f32, device=dev)
        for i in range(chunk):
            act = on[:, i]
            if not bool(act.any()):
                break
            h0 = torch.where(fresh[:, i], zero, hits)
            s0 = torch.where(fresh[:, i], zero, since)
            mk = h0 >= thr
            marked[:, i] = act & mk
            s0s[:, i] = s0
            hits = torch.where(act, h0 + torch.where(attack[:, i],
                                                     zero + 1.0, zero),
                               hits)
            since = torch.where(act, torch.where(mk, s0 + 1.0, zero), since)
        drop = marked if spec.mode == "drop" else \
            marked & (torch.fmod(s0s, keep) != 0)
        out[p[drop]] = MITIGATED
        n_in = on.sum(1)
        last = key.gather(1, (n_in - 1).clamp(min=0)[:, None])[:, 0]
        stored = torch.where(n_in > 0, last, stored)
    keys_out[slot] = stored
    regs_out[slot] = torch.stack([hits, since], 1)
    return keys_out, regs_out, out
