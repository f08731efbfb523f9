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
