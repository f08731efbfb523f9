"""Plain PyTorch version of the flow-register update (counterpart of
``repro.kernels.flow_update.ref``).

One batched update is order dependent — EWMAs do not commute and a later
packet may evict an earlier packet's flow — so this version walks the
batch packet by packet in arrival order.  It is the reference the CUDA
kernels (``csrc/flow_update.cu``, ``fused_flow/csrc/fused_flow.cu``) are
held against, and what the ops run for CPU tensors.

Register row layout (width W = C + E + sum(hist_sizes)):

  ``[0, C)``        counters      ``row += inc``    (counter 0 = pkt count)
  ``[C, C+E)``      EWMAs         first packet of a flow sets ``row = v``;
                                  after that ``ewma_blend(row, v, a)``
  ``[C+E, W)``      histograms    ``row += (col == bin_j)`` for each bins
                                  column j in order (``-1`` = none)

Rows with ``valid == 0`` never touch the table and emit zero feature rows.
"""

from __future__ import annotations

import torch

# Knuth multiplicative constant (2654435761 = 2^32 / phi), xor-folded
HASH_MULT = 2654435761
_M32 = 0xFFFFFFFF


def ewma_blend(row0: torch.Tensor, val: torch.Tensor, alpha: float):
    """``(row0 - row0*a) + val*a``, grouped exactly as the reference.

    With ``alpha`` a power of two both products are exact in f32, so an
    FMA whose product is exact rounds like the separate multiply and add:
    every grouping a compiler may pick computes the same bits."""
    ta = row0 * alpha
    tv = val * alpha
    return (row0 - ta) + tv


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 ``h`` in [0, 2^32), without int64
    overflow: the multiplier is split into 16-bit halves."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_slot(keys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """int32 flow keys -> int32 slot ids in [0, n_slots) (power of two).
    uint32 arithmetic done in int64 with ``& 0xFFFFFFFF``."""
    h = _mul32(keys.to(torch.int64) & _M32, HASH_MULT)
    h = h ^ (h >> 16)
    return (h & (n_slots - 1)).to(torch.int32)


def _as_bins(bins: torch.Tensor, B: int, device) -> torch.Tensor:
    """[B, H] int32 with H >= 1 (a ``-1`` column when no histograms):
    every column then takes at least one ``+ 0.0``, as in the reference."""
    if bins is None or bins.dim() != 2 or bins.shape[1] == 0:
        return torch.full((B, 1), -1, dtype=torch.int32, device=device)
    return bins.to(torch.int32)


def flow_update_ref(keys, regs, pkt_keys, upd, bins, valid, *,
                    n_counters: int, n_ewma: int, alpha: float):
    """-> (keys' [S] i32, regs' [S, W] f32, feats [B, W] f32).

    keys [S] int32 (-1 = empty); regs [S, W] f32; pkt_keys [B] int32 >= 0;
    upd [B, C+E] f32 counter increments ++ EWMA values; bins [B, H] int32
    absolute histogram columns (-1 = none); valid [B] (0 = padding).
    The inputs are not written."""
    S, W = regs.shape
    B = int(pkt_keys.shape[0])
    dev = regs.device
    C, E = n_counters, n_ewma
    upd = upd.to(torch.float32)
    bins = _as_bins(bins, B, dev)
    regs_out = regs.to(torch.float32).clone()
    feats = torch.zeros((B, W), dtype=torch.float32, device=dev)
    col = torch.arange(W, device=dev, dtype=torch.int32)
    zero_row = torch.zeros(W, dtype=torch.float32, device=dev)
    # the control scalars (stored keys, slots, valid) live on the host;
    # every register value is computed on ``regs.device``
    keys_h = keys.to(torch.int32).cpu().tolist()
    pk_h = pkt_keys.to(torch.int32).cpu().tolist()
    slot_h = hash_slot(pkt_keys, S).cpu().tolist()
    valid_h = valid.cpu().tolist()
    for p in range(B):
        if not valid_h[p]:
            continue
        s, key = slot_h[p], pk_h[p]
        fresh = keys_h[s] != key               # evict-on-collision
        row0 = zero_row if fresh else regs_out[s]
        new = row0.clone()
        new[:C] = row0[:C] + upd[p, :C]
        val = upd[p, C:C + E]
        new[C:C + E] = val if fresh else ewma_blend(row0[C:C + E], val,
                                                    alpha)
        for j in range(bins.shape[1]):
            new = new + (col == bins[p, j]).to(torch.float32)
        regs_out[s] = new
        feats[p] = new
        keys_h[s] = key
    keys_out = torch.tensor(keys_h, dtype=torch.int32, device=dev)
    return keys_out, regs_out, feats


def flow_update_staged_ref(keys, regs, pkt_keys, upd, bins, valid, *,
                           n_counters: int, n_ewma: int, alpha: float,
                           chunk: int | None = None):
    """``flow_update_ref``'s result computed the way K1 and K2 walk
    (``kernels/csrc/flow_chain.cuh``): the plain form of their
    decomposition, what shows that it gives the sequential walk's bits.

    - Every packet's terms are folded before any walk, over the whole
      batch: per column the term ``t`` added on the chain, the count ``k``
      of + 1.0 adds left after it (bins that hit a counter or EWMA column,
      or hit one column twice) and the value ``vf`` a fresh row takes.
    - The batch is slot-segmented; each segment is walked in chunks of
      ``chunk`` steps (default ``RT_CHAIN_CHUNK``).  A chunk's eviction
      flags compare adjacent keys, its first step against the key carried
      across the edge (the stored key for the first chunk).
    - On the chain only ``fresh ? vf : (ewma ? r - r*alpha : r) + t``,
      then the k adds.
    Segments are walked side by side (their rows are independent); the
    inputs are not written."""
    from repro_torch.kernels._ext import header_define
    from repro_torch.kernels.flow_update.ops import segment_batch

    chunk = header_define("RT_CHAIN_CHUNK") if chunk is None else chunk
    S, W = regs.shape
    B = int(pkt_keys.shape[0])
    dev = regs.device
    f32 = torch.float32
    C, E = n_counters, n_ewma
    upd = upd.to(f32)
    bins = _as_bins(bins, B, dev)
    H = int(bins.shape[1])
    keys_out = keys.to(torch.int32).clone()
    regs_out = regs.to(f32).clone()
    feats = torch.zeros((B, W), dtype=f32, device=dev)
    if B == 0:
        return keys_out, regs_out, feats
    # the terms, off the chain: [B, W] in arrival order
    col = torch.arange(W, device=dev, dtype=torch.int32)
    is_c = col < C
    is_e = (col >= C) & (col < C + E)
    hits = torch.zeros((B, W), dtype=torch.int64, device=dev)
    for j in range(H):
        hits += (col == bins[:, j:j + 1]).to(torch.int64)
    zero = torch.zeros((B, W), dtype=f32, device=dev)
    u = zero.clone()
    u[:, :C + E] = upd[:, :C + E]
    w = torch.where(is_e, u * alpha, u)
    t_ce = torch.where((hits == 0) & (H > 0), w + zero, w)
    miss = zero if H else torch.full_like(zero, -0.0)    # x + -0.0 == x
    t_h = torch.where(hits > 0, torch.ones_like(zero), miss)
    t = torch.where(is_c | is_e, t_ce, t_h)
    k = torch.where(is_c | is_e, hits, (hits - 1).clamp(min=0))
    start = torch.where(is_c, zero + u, torch.where(is_e, u, zero))
    vf = start + 1.0
    for e in range(1, int(hits.max())):
        vf = torch.where(e < hits, vf + 1.0, vf)
    vf = torch.where(hits > 0, vf, start + zero if H else start)
    n_more = int(k.max())
    # the walk: segments side by side, chunk by chunk
    seg = segment_batch(hash_slot(pkt_keys, S), valid, S)
    live = seg.seg_len > 0
    slot = seg.seg_slot[live].to(torch.int64)
    first = seg.seg_first[live].to(torch.int64)
    length = seg.seg_len[live].to(torch.int64)
    order = seg.order.to(torch.int64)
    pk = pkt_keys.to(torch.int32)
    row = regs_out[slot]
    stored = keys_out[slot]
    steps = torch.arange(chunk, dtype=torch.int64, device=dev)
    for r0 in range(0, int(length.max()) if len(length) else 0, chunk):
        r = r0 + steps
        on = r[None, :] < length[:, None]                   # [K, chunk]
        p = order[torch.where(on, first[:, None] + r[None, :], 0)]
        key = pk[p]
        prev = torch.cat([stored[:, None], key[:, :-1]], 1)
        fresh = on & (key != prev)
        for i in range(chunk):
            act = on[:, i]
            if not bool(act.any()):
                break
            pi = p[:, i]
            v = torch.where(is_e, row - row * alpha, row) + t[pi]
            for e in range(n_more):
                v = torch.where(e < k[pi], v + 1.0, v)
            new = torch.where(fresh[:, i, None], vf[pi], v)
            row = torch.where(act[:, None], new, row)
            feats[pi[act]] = new[act]
        n_in = on.sum(1)
        last = key.gather(1, (n_in - 1).clamp(min=0)[:, None])[:, 0]
        stored = torch.where(n_in > 0, last, stored)
    regs_out[slot] = row
    keys_out[slot] = stored
    return keys_out, regs_out, feats
