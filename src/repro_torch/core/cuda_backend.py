"""CUDA lowering: stage pipelines and model DAGs -> the port's kernel
launches (counterpart of ``repro.core.pallas_backend``).

Pattern matches on the stage list decide which launch serves:

  ``(FlowKey RegisterUpdate [WindowStats])+ <classifier> [Mitigate]``
      -> ``lower_stateful_fused``: ONE K1 launch per batch
         (kernels/fused_flow) for one table or several, the action table
         folded in;
  ``FlowKey RegisterUpdate``
      -> ``lower_stateful``: K2 (kernels/flow_update), one launch per
         table on the split path;
  ``[WindowStats | FeatureSelect]* <MLP classify>``
      -> ``lower_stages_cuda``: K3 (kernels/fused_mlp);
  ``[WindowStats | FeatureSelect]* <MLP>`` (logits, stateless only)
      -> ``lower_stages_cuda``: K5 (kernels/fused_mlp);
  ``[WindowStats | FeatureSelect]* <MAT>``
      -> ``lower_stages_cuda``: K4 (kernels/mat_lut);
  a Seq/Par DAG whose every leaf is ``[FeatureSelect]* <MLP classify>``
      -> ``lower_dag_cuda``: ONE K6 launch (kernels/fused_mlp/fused_dag)
         for the whole DAG, models deduplicated by pipeline identity;
  ``Mitigate`` on the split path
      -> ``lower_mitigation``: the plain ``mitigate_update_segmented``
         on the device tensors, replayed as a CUDA graph on the card.

``<classifier>`` is ``<MLP classify>`` (``FusedClassify``, ``FusedMLP
Reduce(argmax)`` or a ``Dense(relu)* Dense Reduce(argmax)`` chain),
``<MAT>`` (``Quantize LUTGather Reduce [LabelMap]``) or a centroid
classifier (``[FeatureSelect] CentroidDistance Reduce [LabelMap]``).

Nothing here falls back to a plain version where the JAX package has a
kernel.  A pipeline the port cannot serve gets a decline reason
(``fused_flow_decline_reason``, ``stages_decline_reason``,
``dag_decline_reason``) and the caller raises with it, or, for a DAG the
JAX package would fuse, serves it by per-model launches as the JAX
package does past its VMEM budget.  Where the JAX package has no kernel
either, the port runs the plain versions as the JAX package runs its jnp
forms, reported ``"interpret"`` as the JAX package reports them: the
split path's action table (``lower_mitigation``), a split centroid
suffix (``suffix_in_plain_walk``) and a stateless pipeline outside the
JAX package's kernel envelope (``stages_in_plain_walk``: centroid and
tree classifiers, MLPs wider than ``stageir.PALLAS_LANE``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.stageir import (
    PALLAS_LANE,
    CentroidDistance,
    Dense,
    FeatureSelect,
    FlowKey,
    FusedClassify,
    FusedMLP,
    LabelMap,
    LUTGather,
    Quantize,
    Reduce,
    RegisterUpdate,
    WindowStats,
    mlp_widths,
)
from repro_torch.kernels.flow_update.ops import MAX_SLOTS, envelope_reason
from repro_torch.kernels.fused_mlp.ops import mlp_envelope_reason
from repro_torch.kernels.mat_lut.ops import (
    MAX_BINS,
    MAX_CLASSES,
    MAX_FEATURES,
    mat_envelope_reason,
)

_PRELUDE = (FeatureSelect, WindowStats)


def _split_prelude(stages):
    pre, body = [], list(stages)
    while body and isinstance(body[0], _PRELUDE):
        pre.append(body.pop(0))
    return pre, body


def _match_mlp(stages):
    """-> (weights, biases, classify) for dense/fused-MLP runs, else None."""
    if not stages:
        return None
    classify = False
    body = list(stages)
    if isinstance(body[-1], Reduce):
        if body[-1].op != "argmax":
            return None
        classify = True
        body = body[:-1]
    if len(body) == 1 and isinstance(body[0], (FusedMLP, FusedClassify)):
        classify = classify or isinstance(body[0], FusedClassify)
        return list(body[0].weights), list(body[0].biases), classify
    if body and all(isinstance(s, Dense) for s in body):
        if any(s.act != "relu" for s in body[:-1]) or body[-1].act is not None:
            return None
        return [s.w for s in body], [s.b for s in body], classify
    return None


def _match_mat(stages):
    """-> (edges, tables, label map | None, use_min) for
    ``Quantize LUTGather Reduce [LabelMap]``, else None."""
    if len(stages) < 3 or not isinstance(stages[0], Quantize) \
            or not isinstance(stages[1], LUTGather) \
            or not isinstance(stages[2], Reduce):
        return None
    tail = stages[3:]
    if len(tail) > 1 or (tail and not isinstance(tail[0], LabelMap)):
        return None
    lmap = np.asarray(tail[0].table, np.int32) if tail else None
    return (np.asarray(stages[0].edges, np.float32),
            np.asarray(stages[1].tables, np.float32), lmap,
            stages[2].op == "argmin")


def _match_centroid(stages):
    """-> (feature index | None, centroids, label map | None, use_min) for
    ``[FeatureSelect] CentroidDistance Reduce [LabelMap]``, else None."""
    body = list(stages)
    fidx = None
    if body and isinstance(body[0], FeatureSelect):
        fidx = tuple(int(i) for i in np.asarray(body[0].idx).ravel())
        body = body[1:]
    if len(body) < 2 or not isinstance(body[0], CentroidDistance) \
            or not isinstance(body[1], Reduce):
        return None
    tail = body[2:]
    if len(tail) > 1 or (tail and not isinstance(tail[0], LabelMap)):
        return None
    lmap = np.asarray(tail[0].table, np.int32) if tail else None
    return (fidx, np.asarray(body[0].centroids, np.float32), lmap,
            body[1].op == "argmin")


def _classifier(body, n_in: int | None):
    """Match a classifier suffix -> (descriptor, None) or (None, reason).
    The descriptor is ``("mlp", weights, biases)``, ``("mat", edges,
    tables, lmap, use_min)`` or ``("centroid", fidx, centroids, lmap,
    use_min)``."""
    from repro_torch.kernels.fused_flow.ops import centroid_envelope_reason

    mlp = _match_mlp(body)
    if mlp is not None:
        weights, biases, classify = mlp
        if not classify:
            return None, ("classifier lacks an argmax reduce (the "
                          "pipeline must give verdicts)")
        widths = mlp_widths(weights)
        if n_in is not None and widths[0] != n_in:
            return None, "classifier input width mismatch"
        reason = mlp_envelope_reason(widths)
        if reason is not None:
            return None, reason
        return ("mlp", weights, biases), None
    mat = _match_mat(body)
    if mat is not None:
        edges, tables, lmap, use_min = mat
        if edges.ndim != 2 or tables.ndim != 3 \
                or tables.shape[0] != edges.shape[0]:
            return None, "MAT edges and tables disagree on the features"
        if n_in is not None and edges.shape[0] != n_in:
            return None, "classifier input width mismatch"
        reason = mat_envelope_reason(
            edges.shape[0], edges.shape[1], tables.shape[1],
            tables.shape[2], 0 if lmap is None else len(lmap))
        if reason is not None:
            return None, reason
        return ("mat", edges, tables, lmap, use_min), None
    cen = _match_centroid(body)
    if cen is not None:
        fidx, cent, lmap, use_min = cen
        if n_in is not None:
            if fidx is not None and (max(fidx, default=-1) >= n_in
                                     or min(fidx, default=0) < 0
                                     or cent.shape[1] != len(fidx)):
                return None, "classifier input width mismatch"
            if fidx is None and cent.shape[1] != n_in:
                return None, "classifier input width mismatch"
        reason = centroid_envelope_reason(
            cent.shape[0], cent.shape[1], 0 if lmap is None else len(lmap))
        if reason is not None:
            return None, reason
        return ("centroid", fidx, cent, lmap, use_min), None
    return None, "suffix is not an MLP, MAT or centroid classifier"


def _pack_classifier(desc, device):
    """Classifier descriptor -> (SuffixPlan, packed parameters), once at
    lowering time."""
    from repro_torch.kernels.fused_flow import SuffixPlan, pack_centroids
    from repro_torch.kernels.fused_mlp import pack_params
    from repro_torch.kernels.mat_lut import pack_mat

    if desc[0] == "mlp":
        mlp = pack_params(desc[1], desc[2], device=device)
        return SuffixPlan("mlp", mlp.num_classes), mlp
    if desc[0] == "mat":
        _, edges, tables, lmap, use_min = desc
        mat = pack_mat(edges, tables, lmap, use_min=use_min, device=device)
        return SuffixPlan("mat", mat.num_classes), mat
    _, fidx, cent, lmap, use_min = desc
    c = pack_centroids(cent, lmap, fidx, use_min=use_min, device=device)
    return SuffixPlan("centroid", c.num_classes), c


# ----------------------------------------------------- stateless suffix


def _logits_mlp(body):
    """-> (weights, biases) for an MLP without an argmax, else None."""
    mlp = _match_mlp(body)
    return None if mlp is None or mlp[2] else mlp[:2]


def stages_decline_reason(stages, *, verdicts: bool = False) -> str | None:
    """Why ``lower_stages_cuda`` cannot serve ``stages``, or None.
    ``verdicts`` refuses a logits MLP (a stateful suffix needs verdicts)."""
    _, body = _split_prelude(stages)
    logits = _logits_mlp(body)
    if logits is not None and not verdicts:
        return mlp_envelope_reason(mlp_widths(logits[0]))
    desc, reason = _classifier(body, None)
    if reason is None and desc[0] == "centroid":
        return ("a centroid suffix has no stateless kernel (the JAX "
                "package walks it in jnp)")
    return reason


def suffix_in_plain_walk(stages) -> bool:
    """True for a split suffix the JAX package has no kernel for either
    (a centroid classifier, or no classifier at all: a features-only
    pipeline, whose suffix is its readout): it is walked in its plain
    form, reported ``"interpret"``, as the JAX package reports it."""
    body = _split_prelude(stages)[1]
    return not body or _match_centroid(body) is not None


def stages_in_plain_walk(stages) -> bool:
    """True for a stateless pipeline the JAX package walks in jnp instead
    of lowering it onto a Pallas kernel (``pallas_backend.
    pallas_eligible``): anything but an MLP with every width up to
    ``PALLAS_LANE`` or a MAT within the reference's kernel envelope after
    a ``[WindowStats | FeatureSelect]`` prelude."""
    _, body = _split_prelude(stages)
    mlp = _match_mlp(body)
    if mlp is not None:
        return max(mlp_widths(mlp[0])) > PALLAS_LANE
    mat = _match_mat(body)
    if mat is not None:
        _, tables, lmap, _ = mat
        F, bins, C = tables.shape
        n_labels = C if lmap is None else len(lmap)
        return not (F <= MAX_FEATURES and bins <= MAX_BINS
                    and C <= MAX_CLASSES and n_labels <= MAX_CLASSES)
    return True


def lower_stages_cuda(stages, device, *, verdicts: bool = False
                      ) -> Callable | None:
    """``[WindowStats | FeatureSelect]* <MLP | MAT>`` -> ``fn(x [B, F])``
    running the prelude in plain PyTorch and the model as one K3 (MLP
    classify), K5 (MLP logits, unless ``verdicts``) or K4 (MAT) launch;
    None when ``stages_decline_reason``."""
    from repro_torch.kernels.fused_mlp import (
        fused_mlp_classify_packed,
        fused_mlp_packed,
        pack_params,
    )
    from repro_torch.kernels.mat_lut import mat_classify

    if stages_decline_reason(stages, verdicts=verdicts) is not None:
        return None
    pre, body = _split_prelude(stages)
    logits = None if verdicts else _logits_mlp(body)
    if logits is not None:
        op, params = fused_mlp_packed, pack_params(*logits, device=device)
    else:
        desc, _ = _classifier(body, None)
        _, params = _pack_classifier(desc, device)
        op = fused_mlp_classify_packed if desc[0] == "mlp" else mat_classify

    def classify_fn(x, _pre=tuple(pre), _op=op, _params=params):
        for s in _pre:
            x = s.apply(x)
        return _op(x.contiguous(), _params)

    return classify_fn


# ------------------------------------------------------ cross-model DAGs
#
# A Seq/Par DAG whose every leaf is an MLP classifier lowers onto ONE K6
# launch (kernels/fused_mlp fused_dag): every distinct model's weights
# staged once per block, Seq gating and Par or/and merges folded on the
# int32 verdicts in the kernel.  These mirror
# ``repro/core/pallas_backend.py:239-445``; the DAG nodes are the port's
# ``core.alchemy`` Model/Seq/Par.


def _fold_feature_select(pre, w0: np.ndarray, n_feat: int):
    """Fold a FeatureSelect-only prelude into the first-layer weights, by
    the JAX package's rule: ``x[:, idx] @ W0 == x @ S @ W0`` for the 0/1
    selection S, exact when the composite index is strictly increasing
    (the embedded rows keep their summation order, the others add exact
    zeros).  -> the [n_feat, h] first layer, or None for any other
    prelude or an index beyond the DAG's input width."""
    if not all(isinstance(s, FeatureSelect) for s in pre):
        return None
    idx = np.asarray(pre[0].idx, np.int64)
    for s in pre[1:]:
        idx = idx[np.asarray(s.idx, np.int64)]
    if idx.size != w0.shape[0] or np.any(np.diff(idx) <= 0):
        return None
    if idx.size and (int(idx[0]) < 0 or int(idx[-1]) >= n_feat):
        return None
    folded = np.zeros((n_feat, w0.shape[1]), np.float32)
    folded[idx] = np.asarray(w0, np.float32)
    return folded


def _match_dag_leaf(stages):
    """Post-peephole leaf stage list -> (prelude, weights, biases) for a
    classifier K6 takes (an MLP ending in an argmax, within the JAX
    package's kernel widths), else None."""
    pre, body = _split_prelude(stages)
    if any(not isinstance(s, FeatureSelect) for s in pre):
        return None
    mlp = _match_mlp(body)
    if mlp is None or not mlp[2]:        # gating needs int32 verdicts
        return None
    if max(mlp_widths(mlp[0])) > PALLAS_LANE:
        return None
    return pre, list(mlp[0]), list(mlp[1])


def pipeline_of(result, name: str):
    """Accept {name: pipeline} or {name: entry with .pipeline}."""
    entry = result[name]
    return entry.pipeline if hasattr(entry, "pipeline") else entry


def _plan_dag(node, result, combine: str, fuse: bool):
    """Walk the DAG -> (plan, models, None), or (None, None, reason)
    where the DAG leaves K6's pattern.  ``models`` is the list of
    (prelude, weights, biases) deduplicated by pipeline identity (a
    pipeline named twice is one model), ``plan`` the nested structure
    ``kernels.fused_mlp.eval_dag_plan`` folds."""
    from repro_torch.core import stageir
    from repro_torch.core.alchemy import Model, Par, Seq

    models: list = []
    index_of: dict[int, int] = {}        # id(pipeline) -> model slot
    reasons: list = []

    def walk(n):
        if isinstance(n, Model):
            pipe = pipeline_of(result, n.name)
            if id(pipe) not in index_of:
                stages = pipe.stages
                if fuse:
                    stages = stageir.fuse_pipeline_stages(stages)
                leaf = _match_dag_leaf(stages)
                if leaf is None:
                    reasons.append(f"leaf {n.name!r} is not an MLP "
                                   f"classifier of widths <= {PALLAS_LANE}")
                    return None
                index_of[id(pipe)] = len(models)
                models.append(leaf)
            return ("model", index_of[id(pipe)])
        if isinstance(n, (Seq, Par)):
            kind = "seq"
            if isinstance(n, Par):
                if combine not in ("or", "and"):
                    reasons.append(f"combine {combine!r} has no verdict "
                                   "merge")
                    return None
                kind = combine
            parts = [walk(c) for c in n.children]
            if any(p is None for p in parts):
                return None
            return (kind, tuple(parts))
        reasons.append(f"not a DAG node: {type(n).__name__}")
        return None

    plan = walk(node)
    if plan is None:
        return None, None, reasons[0]
    return plan, models, None


def _dag_input_dim(models: list) -> int | None:
    """The DAG input width, read off the leaves without a prelude (every
    model of a DAG reads the same packet rows); None when every leaf hides
    it behind a FeatureSelect."""
    dims = [int(np.shape(w[0])[0]) for pre, w, b in models if not pre]
    return max(dims) if dims else None


def _prepare_dag(node, result, combine: str, fuse: bool):
    """-> (plan, [(weights, biases)] with each FeatureSelect folded, None)
    or (None, None, reason)."""
    from repro_torch.kernels.fused_mlp import dag_envelope_reason

    if len(getattr(node, "leaves", lambda: [None])()) < 2:
        return None, None, "a bare model is not a DAG"
    plan, models, reason = _plan_dag(node, result, combine, fuse)
    if reason is not None:
        return None, None, reason
    n_feat = _dag_input_dim(models)
    if n_feat is None:
        return None, None, ("every leaf hides the input width behind a "
                            "FeatureSelect")
    folded = []
    for pre, weights, biases in models:
        w0 = np.asarray(weights[0], np.float32)
        if pre:
            w0 = _fold_feature_select(pre, w0, n_feat)
            if w0 is None:
                return None, None, ("a FeatureSelect prelude does not fold "
                                    "(its index is not strictly increasing "
                                    "within the input width)")
        elif w0.shape[0] != n_feat:
            return None, None, "the leaves disagree on the input width"
        ws = [w0] + [np.asarray(w, np.float32) for w in weights[1:]]
        if max(mlp_widths(ws)) > PALLAS_LANE:
            return None, None, f"a width exceeds {PALLAS_LANE}"
        folded.append((ws, [np.asarray(b, np.float32) for b in biases]))
    reason = dag_envelope_reason([mlp_widths(ws) for ws, _ in folded], plan)
    if reason is not None:
        return None, None, reason
    return plan, folded, None


def dag_decline_reason(node, result, *, combine: str = "or",
                       fuse: bool = True) -> str | None:
    """Why ``lower_dag_cuda`` does not fuse this DAG into one K6 launch,
    or None.  Shape checks only."""
    return _prepare_dag(node, result, combine, fuse)[2]


def dag_eligible(node, result, *, combine: str = "or",
                 fuse: bool = True) -> bool:
    """Would ``lower_dag_cuda`` fuse this whole DAG into one launch?"""
    return dag_decline_reason(node, result, combine=combine,
                              fuse=fuse) is None


def lower_dag_cuda(node, result, device, *, combine: str = "or",
                   fuse: bool = True) -> Callable | None:
    """The whole Seq/Par DAG -> ``fn(x [B, F]) -> verdicts [B] int32``:
    ONE K6 launch on CUDA tensors (its plain version on CPU tensors), the
    models packed once here; None when ``dag_decline_reason``."""
    from repro_torch.kernels.fused_mlp import fused_dag, pack_dag

    plan, folded, reason = _prepare_dag(node, result, combine, fuse)
    if reason is not None:
        return None
    dag = pack_dag(folded, plan, device=device)
    return lambda x, _dag=dag: fused_dag(x.contiguous(), _dag)


# ------------------------------------------------------ stateful prefixes


def _table_reason(fk, ru) -> str | None:
    spec = ru.spec
    return envelope_reason(spec.n_slots, spec.width, len(spec.hist_sizes))


def lower_stateful(prefix, backend: str) -> Callable:
    """``[FlowKey, RegisterUpdate]`` -> ``fn(keys, regs, x, valid) ->
    (keys', regs', feats)``.  ``backend="cuda"`` runs the op
    ``kernels.flow_update.flow_update`` (K2 on CUDA tensors, which it
    updates in place); ``"interpret"`` the plain sequential walk.  Raises
    for a table outside the kernel envelope under ``"cuda"``."""
    from repro_torch.kernels.flow_update import flow_update, flow_update_ref

    fk, ru = prefix
    if backend == "cuda":
        reason = _table_reason(fk, ru)
        if reason is not None:
            raise ValueError(f"cannot serve on cuda: {reason}")
    update = flow_update if backend == "cuda" else flow_update_ref
    spec = ru.spec

    def flow_fn(keys, regs, x, valid, _fk=fk, _ru=ru, _update=update):
        upd, bins = _ru.prepare(x)
        return _update(keys, regs, _fk.apply_keys(x), upd, bins, valid,
                       n_counters=spec.n_counters, n_ewma=spec.n_ewma,
                       alpha=spec.ewma_alpha)

    return flow_fn


class _GraphedMitigation:
    """``mitigate_update_segmented`` for the split path.  On CUDA tensors
    the same tensor operations are captured once per batch size into a
    CUDA graph and replayed: about 90 small kernels in one launch, where
    eager dispatch costs tens of microseconds of host time each.  The
    update has no host sync, which is what lets it be captured.  Each
    call copies its operands into the graph's inputs and returns copies
    of its outputs, so the given tensors are not written and a result
    outlives the next replay.  CPU tensors run the eager form."""

    def __init__(self, spec):
        self.spec = spec
        self.graphs: dict = {}

    def _capture(self, args):
        import torch

        from repro_torch.kernels.fused_flow.mitigate_ref import (
            mitigate_update_segmented,
        )

        ins = [a.clone() for a in args]
        dev = args[0].device
        side = torch.cuda.Stream(device=dev)   # warm up off the capture
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            mitigate_update_segmented(*ins, spec=self.spec)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = mitigate_update_segmented(*ins, spec=self.spec)
        return graph, ins, outs

    def __call__(self, mit_keys, mit_regs, pkt_keys, verdicts, valid):
        args = (mit_keys, mit_regs, pkt_keys, verdicts, valid)
        if mit_keys.device.type != "cuda":
            from repro_torch.kernels.fused_flow.mitigate_ref import (
                mitigate_update_segmented,
            )

            return mitigate_update_segmented(*args, spec=self.spec)
        key = (mit_keys.device, int(pkt_keys.shape[0]))
        if key not in self.graphs:
            self.graphs[key] = self._capture(args)
        graph, ins, outs = self.graphs[key]
        for dst, src in zip(ins, args):
            dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in outs)


def lower_mitigation(mit) -> tuple[Callable, str]:
    """A trailing ``Mitigate`` for the SPLIT path -> (``fn(mit_keys,
    mit_regs, pkt_keys, verdicts, valid) -> (mit_keys', mit_regs',
    verdicts')``, ``"interpret"``).  The JAX package serves it with its
    jnp scan (``pallas_backend.lower_mitigation``); the port runs the
    plain PyTorch ``mitigate_update_segmented`` on the tensors' device,
    with no host copy or sync, replayed as a CUDA graph on the card.  The
    fused path folds the table into K1 instead."""
    return _GraphedMitigation(mit.spec), "interpret"


# ------------------------------------------------------- fused flow path


def _as_table_groups(prefix_or_groups):
    """A ``[FlowKey, RegisterUpdate]`` prefix (one table) or a
    ``split_stateful_multi`` group list -> [(flow_key, register_update,
    window_stats | None)], or None for anything else."""
    seq = list(prefix_or_groups)
    if seq and isinstance(seq[0], FlowKey):
        if len(seq) != 2 or not isinstance(seq[1], RegisterUpdate):
            return None
        return [(seq[0], seq[1], None)]
    groups = []
    for g in seq:
        if not isinstance(g, (tuple, list)):
            return None
        g = tuple(g)
        if len(g) == 2:
            g = (g[0], g[1], None)
        if len(g) != 3 or not isinstance(g[0], FlowKey) \
                or not isinstance(g[1], RegisterUpdate) \
                or not (g[2] is None or isinstance(g[2], WindowStats)):
            return None
        groups.append(g)
    return groups or None


def _plan_fused(prefix_or_groups, suffix, mitigation=None):
    """-> (desc, reason), exactly one of them None.  ``desc`` = (groups,
    readout modes, classifier descriptor, mitigation spec | None); the
    classifier reads the readouts of every table concatenated in group
    order.  A single table's readout may lead the suffix instead of
    closing its group."""
    from repro_torch.kernels.fused_flow.ops import tables_reason

    groups = _as_table_groups(prefix_or_groups)
    if groups is None:
        return None, "no [FlowKey, RegisterUpdate] table groups"
    reason = tables_reason(len(groups))
    if reason is not None:
        return None, reason
    body = list(suffix)
    if len(groups) == 1 and groups[0][2] is None and body \
            and isinstance(body[0], WindowStats):
        groups[0] = (groups[0][0], groups[0][1], body.pop(0))
    modes, n_in = [], 0
    for fk, ru, ws in groups:
        spec = ru.spec
        reason = _table_reason(fk, ru)
        if reason is not None:
            return None, reason
        if ws is None:
            modes.append("raw")
            n_in += spec.width
            continue
        s = ws.spec
        if (s.width != spec.width or s.n_counters != spec.n_counters
                or s.n_ewma != spec.n_ewma):
            return None, "WindowStats readout disagrees with its table"
        modes.append(ws.mode)
        n_in += ws.n_out
    mit_spec = None
    if mitigation is not None:
        mit_spec = mitigation.spec
        if mit_spec.n_slots > MAX_SLOTS:
            return None, "mitigation table outside the kernel envelope"
    cls, reason = _classifier(body, n_in)
    if reason is not None:
        return None, reason
    return (groups, tuple(modes), cls, mit_spec), None


def fused_flow_decline_reason(prefix_or_groups, suffix,
                              mitigation=None) -> str | None:
    """Why ``lower_stateful_fused`` declines this pipeline; None means the
    single K1 launch serves it.  Shape checks only."""
    return _plan_fused(prefix_or_groups, suffix, mitigation)[1]


def _table_plans(groups, modes):
    from repro_torch.kernels.fused_flow import TablePlan

    return tuple(
        TablePlan(ru.spec.n_counters, ru.spec.n_ewma,
                  len(ru.spec.hist_sizes), float(ru.spec.ewma_alpha),
                  ru.spec.width, mode)
        for (_, ru, _), mode in zip(groups, modes))


def lower_stateful_fused(prefix_or_groups, suffix, device, mitigation=None
                         ) -> Callable | None:
    """The whole stateful pipeline -> ``fn(*state, x, valid) -> (*state',
    verdicts)``, ``state`` being (keys, regs) per table and then, with a
    ``Mitigate`` stage, (mit_keys, mit_regs): one K1 launch per batch on
    CUDA tensors, which it updates in place (the plain version on CPU
    tensors), the classifier packed once here.  One table runs K1's
    one-table mode, several its multi-table mode.  None when
    ``fused_flow_decline_reason`` names a reason."""
    from repro_torch.kernels.fused_flow import (
        fused_flow_serve,
        fused_flow_serve_multi,
    )

    desc, reason = _plan_fused(prefix_or_groups, suffix, mitigation)
    if reason is not None:
        return None
    groups, modes, cls, mit_spec = desc
    tps = _table_plans(groups, modes)
    sp, params = _pack_classifier(cls, device)

    if len(groups) == 1:
        (fk, ru, _), tp = groups[0], tps[0]

        def fused_fn(*args, _fk=fk, _ru=ru, _tp=tp):
            x, valid = args[-2], args[-1]
            upd, bins = _ru.prepare(x)
            mit = None if mit_spec is None else (args[2], args[3], mit_spec)
            return fused_flow_serve(args[0], args[1], _fk.apply_keys(x), upd,
                                    bins, valid, _tp, sp, params, mit=mit)

        return fused_fn

    n = len(groups)

    def fused_multi_fn(*args, _groups=tuple(groups), _tps=tps):
        x, valid = args[-2], args[-1]
        tables = []
        for t, (fk, ru, _) in enumerate(_groups):
            upd, bins = ru.prepare(x)
            tables.append((args[2 * t], args[2 * t + 1], fk.apply_keys(x),
                           upd, bins))
        mit = (None if mit_spec is None
               else (args[2 * n], args[2 * n + 1], mit_spec))
        return fused_flow_serve_multi(tables, valid, _tps, sp, params,
                                      mit=mit)

    return fused_multi_fn
