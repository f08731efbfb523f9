"""Public op: batched flow-register update (counterpart of
``repro.kernels.flow_update.ops``).

``flow_update`` segments the batch by slot and launches CUDA kernel K2
(``csrc/flow_update.cu``) for CUDA tensors; for CPU tensors it runs the
plain version (``ref.flow_update_ref``).  There is no other switch.

Slot segmentation (``segment_batch``, shared with kernels/fused_flow): a
stable sort by slot makes every per-slot chain contiguous while keeping
per-slot arrival order.  The kernel gives each segment one warp that walks
the chain in order, so only the segment tables are needed — the TPU
schedule's lockstep rounds, drain lists and deep-segment table are gone.
The segmentation runs on the device (sort, cumsum, scatter): no host sync.

Envelope: tables up to ``MAX_SLOTS`` slots, rows up to ``MAX_WIDTH``
words (8 columns per lane of a warp), up to ``MAX_HISTS`` histograms.  A
table outside it is refused with the reason, never served slowly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.flow_update.ref import (
    _as_bins,
    flow_update_ref,
    hash_slot,
)

MAX_SLOTS = 1 << 16
MAX_WIDTH = 256
MAX_HISTS = _ext.header_define("RT_MAX_HISTS")


def envelope_reason(n_slots: int, width: int, n_hists: int) -> str | None:
    """Why a table is outside the kernels' envelope, or None."""
    if n_slots > MAX_SLOTS:
        return f"flow table has {n_slots} slots > MAX_SLOTS={MAX_SLOTS}"
    if width > MAX_WIDTH:
        return f"register width {width} > MAX_WIDTH={MAX_WIDTH}"
    if n_hists > MAX_HISTS:
        return f"{n_hists} histograms > MAX_HISTS={MAX_HISTS}"
    return None


class Segments(NamedTuple):
    """Slot-segmented batch layout.  ``order``/``inv`` map between arrival
    and sorted order; ``rank`` is per sorted position; the ``seg_*``
    tables are indexed by segment id (entries past the live segment count
    hold ``seg_len == 0``)."""

    order: torch.Tensor      # [B] arrival index of sorted position i
    inv: torch.Tensor        # [B] sorted position of arrival index p
    rank: torch.Tensor       # [B] position within the slot's chain
    seg_first: torch.Tensor  # [B] segment k's first sorted position
    seg_len: torch.Tensor    # [B] segment k's packet count (0 = padding)
    seg_slot: torch.Tensor   # [B] segment k's table slot


def segment_batch(slot: torch.Tensor, valid: torch.Tensor,
                  n_slots: int) -> Segments:
    """Stable-sort the batch by slot and derive the segment tables (all
    int32).  Invalid rows sort last (keyed ``n_slots``) and never start or
    extend a segment."""
    B = int(slot.shape[0])
    dev = slot.device
    live = valid != 0
    pos = torch.arange(B, dtype=torch.int64, device=dev)
    keyed = torch.where(live, slot.to(torch.int64),
                        torch.full_like(pos, n_slots))
    order = torch.sort(keyed, stable=True).indices
    slot_s = slot.to(torch.int64)[order]
    live_s = live[order]
    is_new = torch.ones(B, dtype=torch.bool, device=dev)
    is_new[1:] = slot_s[1:] != slot_s[:-1]
    is_new &= live_s
    seg_id = torch.cumsum(is_new.to(torch.int64), 0) - 1
    heads = torch.where(is_new, pos, torch.zeros_like(pos))
    rank = pos - torch.cummax(heads, 0).values
    # scatters aim dropped rows at a spare entry B, sliced off after
    head_tgt = torch.where(is_new, seg_id, torch.full_like(pos, B))
    zeros = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    seg_first = zeros.clone().scatter_(0, head_tgt, pos)[:B]
    seg_slot = zeros.clone().scatter_(0, head_tgt, slot_s)[:B]
    len_tgt = torch.where(live_s, seg_id, torch.full_like(pos, B))
    seg_len = zeros.clone().scatter_add_(0, len_tgt,
                                         torch.ones_like(pos))[:B]
    inv = torch.empty(B, dtype=torch.int64, device=dev).scatter_(
        0, order, pos)
    i32 = torch.int32
    return Segments(order.to(i32), inv.to(i32), rank.to(i32),
                    seg_first.to(i32), seg_len.to(i32), seg_slot.to(i32))


def check_operands(keys, regs, pkt_keys, upd, bins, valid, *,
                   n_counters: int, n_ewma: int) -> None:
    """Device, dtype, shape and contiguity checks shared by K1 and K2."""
    S, W = regs.shape
    B = pkt_keys.shape[0]
    dev = regs.device
    want = ((keys, torch.int32, (S,)), (regs, torch.float32, (S, W)),
            (pkt_keys, torch.int32, (B,)),
            (upd, torch.float32, (B, n_counters + n_ewma)),
            (bins, torch.int32, (B, bins.shape[1])),
            (valid, torch.int32, (B,)))
    for t, dt, shape in want:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"flow operand must be contiguous {dt} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    reason = envelope_reason(S, W, bins.shape[1])
    if reason is not None:
        raise ValueError(f"outside the flow-kernel envelope: {reason}")
    if S & (S - 1):
        raise ValueError(f"slot count must be a power of two, got {S}")


def prepare_operands(keys, regs, pkt_keys, upd, bins, valid):
    """Cast to the kernels' dtypes, make contiguous, give bins >= 1
    column, and segment the batch.  -> (operands..., Segments)."""
    B = int(pkt_keys.shape[0])
    keys = keys.to(torch.int32).contiguous()
    regs = regs.to(torch.float32).contiguous()
    pkt_keys = pkt_keys.to(torch.int32).contiguous()
    upd = upd.to(torch.float32).contiguous()
    bins = _as_bins(bins, B, regs.device).contiguous()
    valid = valid.to(torch.int32).contiguous()
    seg = segment_batch(hash_slot(pkt_keys, int(regs.shape[0])), valid,
                        int(regs.shape[0]))
    return keys, regs, pkt_keys, upd, bins, valid, seg


def flow_update_launch(keys, regs, pkt_keys, upd, bins, valid,
                       seg: Segments, *, n_counters: int, n_ewma: int,
                       alpha: float):
    """K2's wrapper: checked, segmented operands -> (keys, regs, feats),
    one launch on the current stream.  ``keys`` and ``regs`` are updated
    in place (only the batch's slots are touched) and returned."""
    check_operands(keys, regs, pkt_keys, upd, bins, valid,
                   n_counters=n_counters, n_ewma=n_ewma)
    if regs.device.type != "cuda":
        raise ValueError("flow_update_launch runs CUDA tensors only")
    feats = torch.empty((pkt_keys.shape[0], regs.shape[1]),
                        dtype=torch.float32, device=regs.device)
    _ext.extension().flow_update(
        keys, regs, pkt_keys, upd, bins, valid, seg.order,
        seg.seg_first, seg.seg_len, seg.seg_slot, feats,
        int(n_counters), int(n_ewma), float(alpha))
    _ext.count_launch("flow_update")
    return keys, regs, feats


def flow_update(keys, regs, pkt_keys, upd, bins, valid, *,
                n_counters: int, n_ewma: int, alpha: float):
    """-> (keys' [S], regs' [S, W], feats [B, W]) in arrival order.

    CUDA tensors: one K2 launch after the on-device segmentation, which
    updates ``keys``/``regs`` in place (they are donated, as the JAX
    package donates the table on accelerators) and returns them.  CPU
    tensors: the plain sequential version, which returns fresh tensors.
    Callers adopt what is returned.  Bit-identical either way."""
    if regs.device.type == "cpu":
        return flow_update_ref(keys, regs, pkt_keys, upd, bins, valid,
                               n_counters=n_counters, n_ewma=n_ewma,
                               alpha=alpha)
    *ops, seg = prepare_operands(keys, regs, pkt_keys, upd, bins, valid)
    return flow_update_launch(*ops, seg, n_counters=n_counters,
                              n_ewma=n_ewma, alpha=alpha)
