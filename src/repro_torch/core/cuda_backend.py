"""CUDA lowering: stage pipelines -> the port's kernel launches
(counterpart of ``repro.core.pallas_backend``).

Pattern matches on the stage list decide which launch serves:

  ``FlowKey RegisterUpdate [WindowStats] <classifier> [Mitigate]``
      -> ``lower_stateful_fused``: ONE K1 launch per batch
         (kernels/fused_flow), the action table folded in;
  ``FlowKey RegisterUpdate``
      -> ``lower_stateful``: K2 (kernels/flow_update), the split path;
  ``[WindowStats | FeatureSelect]* <MLP classify>``
      -> ``lower_stages_cuda``: K3 (kernels/fused_mlp), the split suffix;
  ``[WindowStats | FeatureSelect]* <MAT>``
      -> ``lower_stages_cuda``: K4 (kernels/mat_lut), the split suffix;
  ``Mitigate`` on the split path
      -> ``lower_mitigation``: the plain ``mitigate_update_segmented``
         on the device tensors, replayed as a CUDA graph on the card.

``<classifier>`` is ``<MLP classify>`` (``FusedClassify``, ``FusedMLP
Reduce(argmax)`` or a ``Dense(relu)* Dense Reduce(argmax)`` chain),
``<MAT>`` (``Quantize LUTGather Reduce [LabelMap]``) or a centroid
classifier (``[FeatureSelect] CentroidDistance Reduce [LabelMap]``).

Nothing here falls back to a plain version where the JAX package has a
kernel.  A pipeline the port cannot serve gets a decline reason
(``fused_flow_decline_reason``, ``stages_decline_reason``) and the
caller raises with it.  Two parts have no kernel in the JAX package
either, and run their plain versions here as they run their jnp forms
there, reported ``"interpret"`` as the JAX package reports them: the
split path's action table (``lower_mitigation``) and a split centroid
suffix (``suffix_in_plain_walk``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.stageir import (
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
)
from repro_torch.kernels.flow_update.ops import MAX_SLOTS, envelope_reason
from repro_torch.kernels.fused_mlp.ops import mlp_envelope_reason
from repro_torch.kernels.mat_lut.ops import mat_envelope_reason

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


def _mlp_widths(weights) -> list[int]:
    return [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]


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
            return None, ("classifier lacks an argmax reduce (the logits "
                          "kernel is not yet ported)")
        widths = _mlp_widths(weights)
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


def stages_decline_reason(stages) -> str | None:
    """Why ``lower_stages_cuda`` cannot serve ``stages``, or None."""
    _, body = _split_prelude(stages)
    desc, reason = _classifier(body, None)
    if reason is None and desc[0] == "centroid":
        return ("a centroid suffix has no stateless kernel (the JAX "
                "package walks it in jnp)")
    return reason


def suffix_in_plain_walk(stages) -> bool:
    """True for a split suffix the JAX package has no kernel for either
    (a centroid classifier): it is walked in its plain form, reported
    ``"interpret"``, as the JAX package reports it."""
    return _match_centroid(_split_prelude(stages)[1]) is not None


def lower_stages_cuda(stages, device) -> Callable | None:
    """``[WindowStats | FeatureSelect]* <MLP classify | MAT>`` -> ``fn(x
    [B, F]) -> verdicts [B] int32`` running the prelude in plain PyTorch
    and the classifier as one K3 or K4 launch; None when
    ``stages_decline_reason``."""
    from repro_torch.kernels.fused_mlp import fused_mlp_classify_packed
    from repro_torch.kernels.mat_lut import mat_classify

    if stages_decline_reason(stages) is not None:
        return None
    pre, body = _split_prelude(stages)
    desc, _ = _classifier(body, None)
    _, params = _pack_classifier(desc, device)
    op = fused_mlp_classify_packed if desc[0] == "mlp" else mat_classify

    def classify_fn(x, _pre=tuple(pre), _op=op, _params=params):
        for s in _pre:
            x = s.apply(x)
        return _op(x.contiguous(), _params)

    return classify_fn


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


def _plan_fused(prefix, suffix, mitigation=None):
    """-> (desc, reason), exactly one of them None.  ``desc`` =
    (flow_key, register_update, readout mode, classifier descriptor,
    mitigation spec | None)."""
    seq = list(prefix)
    if len(seq) != 2 or not isinstance(seq[0], FlowKey) \
            or not isinstance(seq[1], RegisterUpdate):
        if seq and all(isinstance(g, (tuple, list)) for g in seq):
            return None, "multi-table plans not yet ported"
        return None, "no [FlowKey, RegisterUpdate] table"
    fk, ru = seq
    spec = ru.spec
    reason = _table_reason(fk, ru)
    if reason is not None:
        return None, reason
    mit_spec = None
    if mitigation is not None:
        mit_spec = mitigation.spec
        if mit_spec.n_slots > MAX_SLOTS:
            return None, "mitigation table outside the kernel envelope"
    body = list(suffix)
    mode, n_in = "raw", spec.width
    if body and isinstance(body[0], WindowStats):
        ws = body.pop(0)
        s = ws.spec
        if (s.width != spec.width or s.n_counters != spec.n_counters
                or s.n_ewma != spec.n_ewma):
            return None, "WindowStats readout disagrees with its table"
        mode, n_in = ws.mode, ws.n_out
    cls, reason = _classifier(body, n_in)
    if reason is not None:
        return None, reason
    return (fk, ru, mode, cls, mit_spec), None


def fused_flow_decline_reason(prefix, suffix, mitigation=None) -> str | None:
    """Why ``lower_stateful_fused`` declines this pipeline; None means the
    single K1 launch serves it.  Shape checks only."""
    return _plan_fused(prefix, suffix, mitigation)[1]


def lower_stateful_fused(prefix, suffix, device, mitigation=None
                         ) -> Callable | None:
    """The whole stateful pipeline -> ``fn(keys, regs, x, valid) ->
    (keys', regs', verdicts)``, or with a ``Mitigate`` stage ``fn(keys,
    regs, mit_keys, mit_regs, x, valid) -> (keys', regs', mit_keys',
    mit_regs', verdicts)``: one K1 launch per batch on CUDA tensors,
    which it updates in place (the plain version on CPU tensors), the
    classifier packed once here; None when ``fused_flow_decline_reason``
    names a reason."""
    from repro_torch.kernels.fused_flow import TablePlan, fused_flow_serve

    desc, reason = _plan_fused(prefix, suffix, mitigation)
    if reason is not None:
        return None
    fk, ru, mode, cls, mit_spec = desc
    spec = ru.spec
    tp = TablePlan(spec.n_counters, spec.n_ewma, len(spec.hist_sizes),
                   float(spec.ewma_alpha), spec.width, mode)
    sp, params = _pack_classifier(cls, device)

    if mit_spec is None:
        def fused_fn(keys, regs, x, valid, _fk=fk, _ru=ru):
            upd, bins = _ru.prepare(x)
            return fused_flow_serve(keys, regs, _fk.apply_keys(x), upd,
                                    bins, valid, tp, sp, params)

        return fused_fn

    def fused_mit_fn(keys, regs, mit_keys, mit_regs, x, valid, _fk=fk,
                     _ru=ru):
        upd, bins = _ru.prepare(x)
        return fused_flow_serve(keys, regs, _fk.apply_keys(x), upd, bins,
                                valid, tp, sp, params,
                                mit=(mit_keys, mit_regs, mit_spec))

    return fused_mit_fn
