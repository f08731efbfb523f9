"""Public op: the whole stateful pipeline as ONE kernel launch
(counterpart of ``repro.kernels.fused_flow.ops.fused_flow_serve``).

``fused_flow_serve`` segments the batch by slot on the device and
launches CUDA kernel K1 (``csrc/fused_flow.cu``): one warp per slot
segment walks the chain, and for each packet reads out the WindowStats
row, runs the MLP from shared memory and writes the verdict straight to
the packet's arrival index (no inverse gather).  CPU tensors run the
plain version, ``ref.fused_flow_serve_ref``.

Limited in this slice to one table, the ``"mlp"`` suffix and no
mitigation.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.flow_update.ops import (
    Segments,
    check_operands,
    prepare_operands,
)
from repro_torch.kernels.fused_flow.ref import (
    READOUT_MODES,
    SuffixPlan,
    TablePlan,
    fused_flow_serve_ref,
)
from repro_torch.kernels.fused_mlp.ops import PackedMLP, check_mlp


def check_plan(regs, tp: TablePlan, sp: SuffixPlan, mlp: PackedMLP):
    if sp.kind != "mlp":
        raise NotImplementedError(f"{sp.kind} suffix not yet ported")
    if tp.mode not in READOUT_MODES:
        raise KeyError(f"readout mode must be one of {READOUT_MODES}")
    if tp.width != regs.shape[1]:
        raise ValueError(f"plan width {tp.width} != table width "
                         f"{regs.shape[1]}")
    if mlp.widths[0] != tp.n_out or sp.num_classes != mlp.num_classes:
        raise ValueError(f"MLP widths {mlp.widths} do not fit the readout "
                         f"width {tp.n_out} / {sp.num_classes} classes")


def fused_flow_serve_launch(keys, regs, pkt_keys, upd, bins, valid,
                            seg: Segments, tp: TablePlan, sp: SuffixPlan,
                            mlp: PackedMLP):
    """K1's wrapper: checked, segmented operands -> (keys, regs,
    verdicts [B] int32 in arrival order), one launch on the current
    stream.  ``keys`` and ``regs`` are updated in place (only the batch's
    slots are touched) and returned."""
    check_operands(keys, regs, pkt_keys, upd, bins, valid,
                   n_counters=tp.n_counters, n_ewma=tp.n_ewma)
    check_plan(regs, tp, sp, mlp)
    check_mlp(mlp, regs.device)
    if regs.device.type != "cuda":
        raise ValueError("fused_flow_serve_launch runs CUDA tensors only")
    verdicts = torch.empty((pkt_keys.shape[0],), dtype=torch.int32,
                           device=regs.device)
    _ext.extension().fused_flow_serve(
        keys, regs, pkt_keys, upd, bins, valid, seg.order,
        seg.seg_first, seg.seg_len, seg.seg_slot, mlp.w_flat, mlp.b_flat,
        list(mlp.widths), verdicts, int(tp.n_counters), int(tp.n_ewma),
        float(tp.alpha), READOUT_MODES.index(tp.mode))
    _ext.count_launch("fused_flow_serve")
    return keys, regs, verdicts


def fused_flow_serve(keys, regs, pkt_keys, upd, bins, valid,
                     tp: TablePlan, sp: SuffixPlan, mlp: PackedMLP):
    """-> (keys' [S], regs' [S, W], verdicts [B] int32 in arrival order).

    CUDA tensors: one K1 launch after the on-device segmentation, which
    updates ``keys``/``regs`` in place (donated, as in ``flow_update``)
    and returns them.  CPU tensors: the plain version, which returns
    fresh tensors.  State is bit-identical either way; verdicts agree up
    to the MLP's summation order."""
    if regs.device.type == "cpu":
        return fused_flow_serve_ref(keys, regs, pkt_keys, upd, bins, valid,
                                    tp, sp, mlp)
    *ops, seg = prepare_operands(keys, regs, pkt_keys, upd, bins, valid)
    return fused_flow_serve_launch(*ops, seg, tp, sp, mlp)
