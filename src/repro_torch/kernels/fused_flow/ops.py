"""Public op: the whole stateful pipeline as ONE kernel launch
(counterpart of ``repro.kernels.fused_flow.ops.fused_flow_serve``).

``fused_flow_serve`` segments the batch by slot on the device — and once
more by action slot when a mitigation table with another slot count is
folded in — and launches CUDA kernel K1 (``csrc/fused_flow.cu``): one
warp per slot segment walks the chain, and for each packet reads out the
WindowStats row, classifies it (MLP, MAT or centroid, parameters staged
in shared memory) and writes the verdict straight to the packet's
arrival index (no inverse gather).  With an action table the same launch
then walks the action chains after a grid-wide barrier.  CPU tensors run
the plain version, ``ref.fused_flow_serve_ref``.

One table per launch in this slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.flow_update.ops import (
    MAX_SLOTS,
    Segments,
    check_operands,
    prepare_operands,
    segment_batch,
)
from repro_torch.kernels.flow_update.ref import hash_slot
from repro_torch.kernels.fused_flow.ref import (
    READOUT_MODES,
    SUFFIX_KINDS,
    Centroids,
    SuffixPlan,
    TablePlan,
    fused_flow_serve_ref,
)
from repro_torch.kernels.fused_flow.mitigate_ref import MitigationSpec
from repro_torch.kernels.fused_mlp.ops import PackedMLP, check_mlp
from repro_torch.kernels.mat_lut.ops import MAX_CLASSES, MatTables, check_mat

MAX_CENTROID_DIM = 128


def centroid_envelope_reason(n_centroids: int, dim: int, n_labels: int
                             ) -> str | None:
    """Why a centroid classifier is outside K1's envelope, or None."""
    if n_centroids > MAX_CLASSES or n_labels > MAX_CLASSES:
        return (f"{n_centroids} centroids / {n_labels} labels > "
                f"{MAX_CLASSES}")
    if dim > MAX_CENTROID_DIM:
        return f"centroid width {dim} > {MAX_CENTROID_DIM}"
    return None


def _check_centroids(c: Centroids, n_in: int, device) -> None:
    K, D = c.cent.shape
    reason = centroid_envelope_reason(K, D, int(c.lmap.shape[0]))
    if reason is not None:
        raise ValueError(f"outside the centroid envelope: {reason}")
    n_sel = c.fidx.numel()       # its range is checked at lowering time
    if n_sel not in (0, D) or (n_sel == 0 and D != n_in) \
            or c.lmap.shape[0] < K:
        raise ValueError(f"centroids [{K}, {D}] with feature index of "
                         f"{n_sel} do not fit a readout of {n_in}")
    for t, dt in ((c.cent, torch.float32), (c.fidx, torch.int32),
                  (c.lmap, torch.int32)):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"centroid operand must be contiguous {dt} "
                             f"on {device}, got {t.dtype} on {t.device}")


def check_plan(regs, tp: TablePlan, sp: SuffixPlan, params) -> None:
    if sp.kind not in SUFFIX_KINDS:
        raise KeyError(f"suffix kind must be one of {SUFFIX_KINDS}")
    if tp.mode not in READOUT_MODES:
        raise KeyError(f"readout mode must be one of {READOUT_MODES}")
    if tp.width != regs.shape[1]:
        raise ValueError(f"plan width {tp.width} != table width "
                         f"{regs.shape[1]}")
    dev = regs.device
    if sp.kind == "mlp":
        if not isinstance(params, PackedMLP) \
                or params.widths[0] != tp.n_out \
                or sp.num_classes != params.num_classes:
            raise ValueError(f"MLP does not fit the readout width "
                             f"{tp.n_out} / {sp.num_classes} classes")
        check_mlp(params, dev)
    elif sp.kind == "mat":
        if not isinstance(params, MatTables) \
                or params.n_features != tp.n_out \
                or sp.num_classes != params.num_classes:
            raise ValueError(f"MAT does not fit the readout width "
                             f"{tp.n_out} / {sp.num_classes} classes")
        check_mat(params, dev)
    else:
        if not isinstance(params, Centroids) \
                or sp.num_classes != params.num_classes:
            raise ValueError("centroid parameters do not fit the plan")
        _check_centroids(params, tp.n_out, dev)


def _suffix_operands(sp: SuffixPlan, params):
    """-> (kind id, parameter tensors, integer dims) for the binding."""
    if sp.kind == "mlp":
        return 0, [params.w_flat, params.b_flat], list(params.widths)
    if sp.kind == "mat":
        return 1, [params.edges, params.tables, params.lmap], \
            [int(params.use_min)]
    return 2, [params.cent, params.fidx, params.lmap], [int(params.use_min)]


def check_mitigation(mit_keys, mit_regs, spec: MitigationSpec,
                     device) -> None:
    Sm = mit_keys.shape[0]
    for t, dt, shape in ((mit_keys, torch.int32, (Sm,)),
                         (mit_regs, torch.float32, (Sm, 2))):
        if t.device != device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"action table operand must be contiguous {dt}"
                             f" {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if Sm != spec.n_slots or Sm > MAX_SLOTS:
        raise ValueError(f"action table of {Sm} slots for a spec of "
                         f"{spec.n_slots}, at most {MAX_SLOTS}")


def mitigation_segments(pkt_keys, valid, seg: Segments, n_slots: int,
                        n_mit_slots: int) -> Segments:
    """The action table's slot segmentation: the flow table's when both
    have the same slot count (the same hash gives the same slots)."""
    if n_mit_slots == n_slots:
        return seg
    return segment_batch(hash_slot(pkt_keys, n_mit_slots), valid,
                         n_mit_slots)


def fused_flow_serve_launch(keys, regs, pkt_keys, upd, bins, valid,
                            seg: Segments, tp: TablePlan, sp: SuffixPlan,
                            params, mit=None, mseg: Segments | None = None):
    """K1's wrapper: checked, segmented operands -> (keys, regs, verdicts
    [B] int32 in arrival order), or with ``mit = (mit_keys, mit_regs,
    MitigationSpec)`` and its segmentation ``mseg`` -> (keys, regs,
    mit_keys, mit_regs, verdicts); one launch on the current stream.
    The tables are updated in place (only the batch's slots) and
    returned."""
    check_operands(keys, regs, pkt_keys, upd, bins, valid,
                   n_counters=tp.n_counters, n_ewma=tp.n_ewma)
    check_plan(regs, tp, sp, params)
    if regs.device.type != "cuda":
        raise ValueError("fused_flow_serve_launch runs CUDA tensors only")
    kind, tensors, dims = _suffix_operands(sp, params)
    mit_ops, policy = [], []
    if mit is not None:
        mk, mr, spec = mit
        check_mitigation(mk, mr, spec, regs.device)
        if mseg is None:
            raise ValueError("a mitigated launch needs its segmentation")
        mit_ops = [mk, mr, mseg.order, mseg.seg_first, mseg.seg_len,
                   mseg.seg_slot]
        policy = [float(spec.threshold), float(spec.keep_every),
                  float(spec.attack_class),
                  1.0 if spec.mode == "drop" else 0.0]
    verdicts = torch.empty((pkt_keys.shape[0],), dtype=torch.int32,
                           device=regs.device)
    _ext.extension().fused_flow_serve(
        keys, regs, pkt_keys, upd, bins, valid, seg.order,
        seg.seg_first, seg.seg_len, seg.seg_slot, kind, tensors, dims,
        verdicts, int(tp.n_counters), int(tp.n_ewma), float(tp.alpha),
        READOUT_MODES.index(tp.mode), mit_ops, policy)
    _ext.count_launch("fused_flow_serve")
    if mit is None:
        return keys, regs, verdicts
    return keys, regs, mit[0], mit[1], verdicts


def fused_flow_serve(keys, regs, pkt_keys, upd, bins, valid,
                     tp: TablePlan, sp: SuffixPlan, params, mit=None):
    """-> (keys' [S], regs' [S, W], verdicts [B] int32 in arrival order),
    with ``mit = (mit_keys, mit_regs, MitigationSpec)`` -> (keys', regs',
    mit_keys', mit_regs', verdicts), dropped packets ``MITIGATED``.

    CUDA tensors: one K1 launch after the on-device segmentation(s),
    which updates the tables in place (donated, as in ``flow_update``)
    and returns them.  CPU tensors: the plain version, which returns
    fresh tensors.  State is bit-identical either way; MLP and centroid
    verdicts agree up to their summation order, MAT verdicts exactly."""
    if regs.device.type == "cpu":
        return fused_flow_serve_ref(keys, regs, pkt_keys, upd, bins, valid,
                                    tp, sp, params, mit)
    *ops, seg = prepare_operands(keys, regs, pkt_keys, upd, bins, valid)
    mseg = None
    if mit is not None:
        mk, mr, spec = mit
        mit = (mk.to(torch.int32).contiguous(),
               mr.to(torch.float32).contiguous(), spec)
        mseg = mitigation_segments(ops[2], ops[5], seg,
                                   int(regs.shape[0]), int(mk.shape[0]))
    return fused_flow_serve_launch(*ops, seg, tp, sp, params, mit, mseg)
