"""Public op: the whole stateful pipeline as ONE kernel launch
(counterpart of ``repro.kernels.fused_flow.ops.fused_flow_serve``).

``fused_flow_serve`` segments the batch by slot on the device — and once
more by action slot when a mitigation table with another slot count is
folded in — and launches CUDA kernel K1 (``csrc/fused_flow.cu``), one
cooperative launch in three phases: one warp per slot segment walks the
chain and stores each packet's post-update row into a scratch row of
``z`` at the packet's arrival index (the TPU kernel's inverse gather
becomes a scatter); after a grid-wide barrier one warp per packet reads
its row out (WindowStats) and classifies it (MLP, MAT or centroid,
parameters staged in shared memory); with an action table, after a
second barrier, one warp per action segment walks the action chain.  CPU
tensors run the plain version, ``ref.fused_flow_serve_ref``.

``fused_flow_serve_multi`` is the multi-table mode: several flow tables
feeding one classifier, the same launch with one segmentation per table
and each table's rows at its column offset of ``z``; the action table is
keyed by table 0's keys.  CPU tensors run
``ref.fused_flow_serve_multi_ref``.
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
    fused_flow_serve_multi_ref,
    fused_flow_serve_ref,
)
from repro_torch.kernels.fused_flow.mitigate_ref import MitigationSpec
from repro_torch.kernels.fused_mlp.ops import PackedMLP, check_mlp
from repro_torch.kernels.mat_lut.ops import MAX_CLASSES, MatTables, check_mat

MAX_CENTROID_DIM = 128
# Tables one multi-table launch takes: their descriptors ride by value in
# the kernel's parameter space (32,764 bytes on Hopper from CUDA 12.1 on)
MAX_TABLES = _ext.header_define("RT_MAX_TABLES")


def tables_reason(n_tables: int) -> str | None:
    """Why K1 cannot take ``n_tables`` flow tables in one launch, or
    None."""
    if n_tables > MAX_TABLES:
        return (f"{n_tables} flow tables > {MAX_TABLES} (the kernel "
                "parameter space)")
    return None


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


def _check_table_plan(regs, tp: TablePlan) -> None:
    if tp.mode not in READOUT_MODES:
        raise KeyError(f"readout mode must be one of {READOUT_MODES}")
    if tp.width != regs.shape[1]:
        raise ValueError(f"plan width {tp.width} != table width "
                         f"{regs.shape[1]}")


def check_suffix(sp: SuffixPlan, params, n_in: int, dev) -> None:
    """The classifier's parameters fit a readout row of ``n_in``."""
    if sp.kind not in SUFFIX_KINDS:
        raise KeyError(f"suffix kind must be one of {SUFFIX_KINDS}")
    if sp.kind == "mlp":
        if not isinstance(params, PackedMLP) \
                or params.widths[0] != n_in \
                or sp.num_classes != params.num_classes:
            raise ValueError(f"MLP does not fit the readout width "
                             f"{n_in} / {sp.num_classes} classes")
        check_mlp(params, dev)
    elif sp.kind == "mat":
        if not isinstance(params, MatTables) \
                or params.n_features != n_in \
                or sp.num_classes != params.num_classes:
            raise ValueError(f"MAT does not fit the readout width "
                             f"{n_in} / {sp.num_classes} classes")
        check_mat(params, dev)
    else:
        if not isinstance(params, Centroids) \
                or sp.num_classes != params.num_classes:
            raise ValueError("centroid parameters do not fit the plan")
        _check_centroids(params, n_in, dev)


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
    return fused_flow_serve_multi_launch(
        [(keys, regs, pkt_keys, upd, bins)], valid, [seg], [tp], sp, params,
        mit, mseg)


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
    mit, mseg = _prepare_mitigation(mit, ops[2], ops[5], seg,
                                    int(regs.shape[0]))
    return fused_flow_serve_launch(*ops, seg, tp, sp, params, mit, mseg)


def _prepare_mitigation(mit, pkt_keys, valid, seg: Segments, n_slots: int):
    """-> (mit with contiguous tables, its segmentation), or (None,
    None)."""
    if mit is None:
        return None, None
    mk, mr, spec = mit
    mit = (mk.to(torch.int32).contiguous(),
           mr.to(torch.float32).contiguous(), spec)
    return mit, mitigation_segments(pkt_keys, valid, seg, n_slots,
                                    int(mk.shape[0]))


def _mitigation_operands(mit, mseg, device):
    """-> (the binding's action-table tensors, its policy values)."""
    if mit is None:
        return [], []
    mk, mr, spec = mit
    check_mitigation(mk, mr, spec, device)
    if mseg is None:
        raise ValueError("a mitigated launch needs its segmentation")
    return ([mk, mr, mseg.order, mseg.seg_first, mseg.seg_len,
             mseg.seg_slot],
            [float(spec.threshold), float(spec.keep_every),
             float(spec.attack_class), 1.0 if spec.mode == "drop" else 0.0])


def fused_flow_serve_multi_launch(tables, valid, segs, tps, sp: SuffixPlan,
                                  params, mit=None,
                                  mseg: Segments | None = None):
    """K1's multi-table wrapper: per table checked operands (keys, regs,
    pkt_keys, upd, bins) with their segmentation ``segs`` and
    ``TablePlan``s ``tps`` -> per table (keys, regs), then (mit_keys,
    mit_regs) with ``mit``, then verdicts [B] int32 in arrival order; one
    cooperative launch on the current stream.  The tables are updated in
    place and returned."""
    tables, tps = list(tables), list(tps)
    reason = tables_reason(len(tables))
    if reason is not None:
        raise ValueError(reason)
    if not tables or len(tps) != len(tables) or len(segs) != len(tables):
        raise ValueError("one TablePlan and one segmentation per table")
    dev = tables[0][1].device
    if dev.type != "cuda":
        raise ValueError("fused_flow_serve_multi_launch runs CUDA tensors "
                         "only")
    for (keys, regs, pkt_keys, upd, bins), tp in zip(tables, tps):
        check_operands(keys, regs, pkt_keys, upd, bins, valid,
                       n_counters=tp.n_counters, n_ewma=tp.n_ewma)
        _check_table_plan(regs, tp)
        if regs.device != dev or pkt_keys.shape != tables[0][2].shape:
            raise ValueError("every table takes the same batch on one "
                             "device")
    check_suffix(sp, params, sum(tp.n_out for tp in tps), dev)
    flat, dims, alphas = [], [], []
    for (keys, regs, pkt_keys, upd, bins), tp, seg in zip(tables, tps,
                                                          segs):
        flat += [keys, regs, pkt_keys, upd, bins, seg.order, seg.seg_first,
                 seg.seg_len, seg.seg_slot]
        dims += [int(tp.n_counters), int(tp.n_ewma),
                 READOUT_MODES.index(tp.mode)]
        alphas.append(float(tp.alpha))
    kind, tensors, sdims = _suffix_operands(sp, params)
    mit_ops, policy = _mitigation_operands(mit, mseg, dev)
    B = int(valid.shape[0])
    # the post-update rows, each table's starting on a 128-byte line (a
    # misaligned row costs the walking warp a second line per store)
    z = torch.empty((B, sum(-(-tp.width // 32) * 32 for tp in tps)),
                    dtype=torch.float32, device=dev)
    verdicts = torch.empty((B,), dtype=torch.int32, device=dev)
    _ext.extension().fused_flow_serve(
        flat, valid, dims, alphas, kind, tensors, sdims, z, verdicts,
        mit_ops, policy)
    _ext.count_launch("fused_flow_serve")
    outs = [t for tab in tables for t in tab[:2]]
    if mit is not None:
        outs += [mit[0], mit[1]]
    return (*outs, verdicts)


def fused_flow_serve_multi(tables, valid, tps, sp: SuffixPlan, params,
                           mit=None):
    """Several flow tables feeding one classifier, as ONE K1 launch.
    ``tables``: per table (keys [S_t], regs [S_t, W_t], pkt_keys [B],
    upd [B, C_t+E_t], bins [B, H_t]), one ``TablePlan`` each in ``tps``.
    -> per table (keys', regs'), then (mit_keys', mit_regs') with ``mit =
    (mit_keys, mit_regs, MitigationSpec)``, then verdicts [B] int32 in
    arrival order, dropped packets ``MITIGATED``.  The action table is
    keyed by table 0's keys.

    CUDA tensors: each table segmented on the device, one launch that
    updates the tables in place.  CPU tensors: the plain version, which
    returns fresh tensors."""
    if tables[0][1].device.type == "cpu":
        return fused_flow_serve_multi_ref(tables, valid, tps, sp, params,
                                          mit)
    prepared, segs = [], []
    for keys, regs, pkt_keys, upd, bins in tables:
        *ops, seg = prepare_operands(keys, regs, pkt_keys, upd, bins, valid)
        prepared.append(tuple(ops[:5]))
        segs.append(seg)
    valid = ops[5]
    mit, mseg = _prepare_mitigation(mit, prepared[0][2], valid, segs[0],
                                    int(prepared[0][1].shape[0]))
    return fused_flow_serve_multi_launch(prepared, valid, segs, tps, sp,
                                         params, mit, mseg)
