"""CUDA lowering: stage pipelines -> the port's kernel launches
(counterpart of ``repro.core.pallas_backend``).

Pattern matches on the stage list decide which launch serves:

  ``FlowKey RegisterUpdate [WindowStats] <MLP classify>``
      -> ``lower_stateful_fused``: ONE K1 launch per batch
         (kernels/fused_flow);
  ``FlowKey RegisterUpdate``
      -> ``lower_stateful``: K2 (kernels/flow_update), the split path;
  ``[WindowStats | FeatureSelect]* <MLP classify>``
      -> ``lower_stages_cuda``: K3 (kernels/fused_mlp), the split suffix.

``<MLP classify>`` is ``FusedClassify``, ``FusedMLP Reduce(argmax)`` or a
``Dense(relu)* Dense Reduce(argmax)`` chain.

Nothing here falls back.  A pipeline the port cannot serve gets a decline
reason (``fused_flow_decline_reason``, ``stages_decline_reason``) and the
caller raises with it.  The MAT and centroid suffixes, mitigation and
multi-table plans are recognised and declined by name until their slices
land.
"""

from __future__ import annotations

from typing import Callable

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
from repro_torch.kernels.flow_update.ops import envelope_reason
from repro_torch.kernels.fused_mlp.ops import mlp_envelope_reason

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


def _is_mat(stages) -> bool:
    return (len(stages) >= 3 and isinstance(stages[0], Quantize)
            and isinstance(stages[1], LUTGather)
            and isinstance(stages[2], Reduce)
            and all(isinstance(s, LabelMap) for s in stages[3:]))


def _is_centroid(stages) -> bool:
    body = list(stages)
    if body and isinstance(body[0], FeatureSelect):
        body = body[1:]
    return (len(body) >= 2 and isinstance(body[0], CentroidDistance)
            and isinstance(body[1], Reduce)
            and all(isinstance(s, LabelMap) for s in body[2:]))


def _mlp_widths(weights) -> list[int]:
    return [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]


def _classifier(body, n_in: int | None):
    """Match a classifier suffix -> ((weights, biases), None) or
    (None, reason)."""
    mlp = _match_mlp(body)
    if mlp is None:
        if _is_mat(body):
            return None, "mat suffix not yet ported"
        if _is_centroid(body):
            return None, "centroid suffix not yet ported"
        return None, "suffix is not an MLP classifier"
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
    return (weights, biases), None


# ----------------------------------------------------- stateless suffix


def stages_decline_reason(stages) -> str | None:
    """Why ``lower_stages_cuda`` cannot serve ``stages``, or None."""
    _, body = _split_prelude(stages)
    return _classifier(body, None)[1]


def lower_stages_cuda(stages, device) -> Callable | None:
    """``[WindowStats | FeatureSelect]* <MLP classify>`` -> ``fn(x [B, F])
    -> verdicts [B] int32`` running the prelude in plain PyTorch and the
    classifier as one K3 launch; None when ``stages_decline_reason``."""
    from repro_torch.kernels.fused_mlp import (
        fused_mlp_classify_packed,
        pack_params,
    )

    pre, body = _split_prelude(stages)
    cls, reason = _classifier(body, None)
    if reason is not None:
        return None
    mlp = pack_params(*cls, device=device)

    def classify_fn(x, _pre=tuple(pre), _mlp=mlp):
        for s in _pre:
            x = s.apply(x)
        return fused_mlp_classify_packed(x.contiguous(), _mlp)

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


# ------------------------------------------------------- fused flow path


def _plan_fused(prefix, suffix, mitigation=None):
    """-> (desc, reason), exactly one of them None.  ``desc`` =
    (flow_key, register_update, readout mode, (weights, biases))."""
    seq = list(prefix)
    if len(seq) != 2 or not isinstance(seq[0], FlowKey) \
            or not isinstance(seq[1], RegisterUpdate):
        if seq and all(isinstance(g, (tuple, list)) for g in seq):
            return None, "multi-table plans not yet ported"
        return None, "no [FlowKey, RegisterUpdate] table"
    if mitigation is not None:
        return None, "mitigation not yet ported"
    fk, ru = seq
    spec = ru.spec
    reason = _table_reason(fk, ru)
    if reason is not None:
        return None, reason
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
    return (fk, ru, mode, cls), None


def fused_flow_decline_reason(prefix, suffix, mitigation=None) -> str | None:
    """Why ``lower_stateful_fused`` declines this pipeline; None means the
    single K1 launch serves it.  Shape checks only."""
    return _plan_fused(prefix, suffix, mitigation)[1]


def lower_stateful_fused(prefix, suffix, device) -> Callable | None:
    """The whole stateful pipeline -> ``fn(keys, regs, x, valid) ->
    (keys', regs', verdicts)``, one K1 launch per batch on CUDA tensors,
    which it updates in place (the plain version on CPU tensors),
    classifier packed once here;
    None when ``fused_flow_decline_reason`` names a reason."""
    from repro_torch.kernels.fused_flow import (
        SuffixPlan,
        TablePlan,
        fused_flow_serve,
    )
    from repro_torch.kernels.fused_mlp import pack_params

    desc, reason = _plan_fused(prefix, suffix)
    if reason is not None:
        return None
    fk, ru, mode, (weights, biases) = desc
    spec = ru.spec
    tp = TablePlan(spec.n_counters, spec.n_ewma, len(spec.hist_sizes),
                   float(spec.ewma_alpha), spec.width, mode)
    mlp = pack_params(weights, biases, device=device)
    sp = SuffixPlan("mlp", mlp.num_classes)

    def fused_fn(keys, regs, x, valid, _fk=fk, _ru=ru):
        upd, bins = _ru.prepare(x)
        return fused_flow_serve(keys, regs, _fk.apply_keys(x), upd, bins,
                                valid, tp, sp, mlp)

    return fused_fn
