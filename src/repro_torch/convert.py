"""Carry stage lists and register state across from the reference
package without importing it.

``stages_from_reference`` reads each reference stage's ``kind`` string
and its dataclass fields (numpy arrays, ints, tuples) and builds the
port's stage; nothing here imports ``repro`` or ``jax``, so the port can
serve pipelines the reference compiler generated.  ``state_from_numpy`` /
``state_to_numpy`` move a register file (or a multi-table pipeline's
files) across as numpy arrays, and ``mitigation_from_numpy`` /
``mitigation_to_numpy`` the action table, ``sharded_state_from_reference``
a sharded engine's stacked tables into one table per shard.
``dag_from_reference`` and ``pipelines_from_reference`` carry a model
DAG and the pipelines it names; ``lm_params_from_reference`` an LM's
parameter tree and ``train_state_from_reference`` its training state
(params, optimizer moments, step); ``trained_from_reference`` a
trained model (its numpy parameters, topology and config) into the
port's ``TrainedModel``;
``fused_from_reference`` a fused multi-task model (``core.fusion``) and
``result_from_reference`` a whole ``GenerationResult``, its trained
models, pipelines and ``FeasibilityReport``s, one port object for each
reference object, so the Table-3 dedup (``chaining.dag_resources``)
counts a shared model once in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import alchemy, mlalgos, stageir
from repro_torch.data.netdata import Dataset
from repro_torch.device import resolve_device
from repro_torch.flowstate.mitigation import (
    MitigatedFlowState,
    MitigationSpec,
)
from repro_torch.flowstate.registers import (
    FlowState,
    FlowStateSpec,
    MultiFlowState,
)
from repro_torch.models.moe import expert_range


def spec_from_reference(spec) -> FlowStateSpec:
    return FlowStateSpec(
        n_slots=int(spec.n_slots), n_counters=int(spec.n_counters),
        n_ewma=int(spec.n_ewma),
        hist_sizes=tuple(int(h) for h in spec.hist_sizes),
        ewma_alpha=float(spec.ewma_alpha))


def mitigation_spec_from_reference(spec) -> MitigationSpec:
    return MitigationSpec(
        n_slots=int(spec.n_slots), mode=str(spec.mode),
        threshold=int(spec.threshold), keep_every=int(spec.keep_every),
        attack_class=int(spec.attack_class))


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _ints(t) -> tuple:
    return tuple(int(c) for c in t)


_CONVERT = {
    "feature_select": lambda s: stageir.FeatureSelect(np.asarray(s.idx)),
    "dense": lambda s: stageir.Dense(_f32(s.w), _f32(s.b), s.act),
    "fused_mlp": lambda s: stageir.FusedMLP(
        [_f32(w) for w in s.weights], [_f32(b) for b in s.biases]),
    "fused_classify": lambda s: stageir.FusedClassify(
        [_f32(w) for w in s.weights], [_f32(b) for b in s.biases]),
    "centroid_distance": lambda s: stageir.CentroidDistance(
        _f32(s.centroids)),
    "quantize": lambda s: stageir.Quantize(_f32(s.edges)),
    "lut_gather": lambda s: stageir.LUTGather(_f32(s.tables)),
    "tree_traverse": lambda s: stageir.TreeTraverse(
        np.asarray(s.feat, np.int32), _f32(s.thr),
        np.asarray(s.left, np.int32), np.asarray(s.right, np.int32),
        np.asarray(s.leaf_class, np.int32), np.asarray(s.is_leaf, bool),
        int(s.depth)),
    "reduce": lambda s: stageir.Reduce(str(s.op)),
    "label_map": lambda s: stageir.LabelMap(np.asarray(s.table, np.int32)),
    "flow_key": lambda s: stageir.FlowKey(_ints(s.key_cols),
                                          int(s.n_slots)),
    "register_update": lambda s: stageir.RegisterUpdate(
        spec_from_reference(s.spec), _ints(s.counter_cols),
        _ints(s.ewma_cols), _ints(s.hist_cols),
        tuple(np.asarray(e) for e in s.hist_edges)),
    "window_stats": lambda s: stageir.WindowStats(
        spec_from_reference(s.spec), str(s.mode)),
    "mitigate": lambda s: stageir.Mitigate(
        mitigation_spec_from_reference(s.spec)),
}


def stages_from_reference(stages) -> list:
    """Reference stage list -> the port's stages, parameters as numpy."""
    out = []
    for s in stages:
        kind = getattr(s, "kind", None)
        if kind not in _CONVERT:
            raise NotImplementedError(f"stage kind {kind!r} not yet ported")
        out.append(_CONVERT[kind](s))
    return out


def dag_from_reference(node):
    """A reference ``Model``/``Seq``/``Par`` DAG (read by class name) ->
    the port's ``core.alchemy`` nodes, models by name."""
    kind = type(node).__name__
    if kind == "Model":
        return alchemy.Model(node.name)
    if kind in ("Seq", "Par"):
        cls = alchemy.Seq if kind == "Seq" else alchemy.Par
        return cls([dag_from_reference(c) for c in node.children])
    raise TypeError(f"not a DAG node: {kind}")


def pipelines_from_reference(result, *, device="cuda") -> dict:
    """``{name: reference pipeline with .stages}`` (or entries with a
    ``.pipeline``) -> ``{name: stageir.StagePipeline}``.  One reference
    pipeline maps to one port object, so a pipeline named twice stays one
    model where the DAG lowering deduplicates by identity."""
    out, seen = {}, {}
    for name in result:
        entry = result[name]
        pipe = entry.pipeline if hasattr(entry, "pipeline") else entry
        if id(pipe) not in seen:
            seen[id(pipe)] = stageir.StagePipeline(
                stages_from_reference(pipe.stages), device=device)
        out[name] = seen[id(pipe)]
    return out


def _table_from_numpy(keys, regs, spec: FlowStateSpec, dev):
    keys = torch.as_tensor(np.asarray(keys, np.int32), device=dev)
    regs = torch.as_tensor(np.asarray(regs, np.float32), device=dev)
    if tuple(keys.shape) != (spec.n_slots,) \
            or tuple(regs.shape) != (spec.n_slots, spec.width):
        raise ValueError(f"state shapes {tuple(keys.shape)}, "
                         f"{tuple(regs.shape)} do not match {spec}")
    return keys, regs


def state_from_numpy(keys, regs, spec, device="cuda"):
    """[S] int32 keys + [S, W] f32 rows -> a ``FlowState`` on ``device``;
    with a sequence of specs, one (keys, regs) pair per table -> a
    ``MultiFlowState``."""
    dev = resolve_device(device)
    if isinstance(spec, FlowStateSpec):
        return FlowState(spec, *_table_from_numpy(keys, regs, spec, dev))
    specs = tuple(spec)
    if not (len(keys) == len(regs) == len(specs)):
        raise ValueError("one keys and one regs array per table")
    pairs = [_table_from_numpy(k, r, sp, dev)
             for k, r, sp in zip(keys, regs, specs)]
    return MultiFlowState(specs, tuple(k for k, _ in pairs),
                          tuple(r for _, r in pairs))


def state_to_numpy(state):
    """-> (keys [S] int32, regs [S, W] f32) on the host; for a
    ``MultiFlowState`` -> (tuple of keys, tuple of regs), one per
    table."""
    def host(k, r):
        return (k.cpu().numpy().astype(np.int32),
                r.cpu().numpy().astype(np.float32))

    if isinstance(state, MultiFlowState):
        pairs = [host(k, r) for k, r in zip(state.keys_list,
                                            state.regs_list)]
        return tuple(k for k, _ in pairs), tuple(r for _, r in pairs)
    return host(state.keys, state.regs)


def mitigation_from_numpy(state, mit_keys, mit_regs,
                          mit_spec: MitigationSpec):
    """A register file (``FlowState``) or a multi-table pipeline's files
    (``MultiFlowState``) + [Sm] int32 action keys + [Sm, 2] f32 [hits,
    since] rows -> a ``MitigatedFlowState`` or a mitigated
    ``MultiFlowState`` on the register files' device."""
    dev = state.keys.device
    mk = torch.as_tensor(np.asarray(mit_keys, np.int32), device=dev)
    mr = torch.as_tensor(np.asarray(mit_regs, np.float32), device=dev)
    if tuple(mk.shape) != (mit_spec.n_slots,) \
            or tuple(mr.shape) != (mit_spec.n_slots, mit_spec.width):
        raise ValueError(f"action table shapes {tuple(mk.shape)}, "
                         f"{tuple(mr.shape)} do not match {mit_spec}")
    if isinstance(state, MultiFlowState):
        return MultiFlowState(state.specs, state.keys_list, state.regs_list,
                              mit_spec, mk, mr)
    return MitigatedFlowState(state.spec, state.keys, state.regs, mit_spec,
                              mk, mr)


def mitigation_to_numpy(state) -> tuple[np.ndarray, np.ndarray]:
    """-> (mit_keys [Sm] int32, mit_regs [Sm, 2] f32) on the host."""
    return (state.mit_keys.cpu().numpy().astype(np.int32),
            state.mit_regs.cpu().numpy().astype(np.float32))


def sharded_state_from_reference(state, *, devices):
    """A reference ``ShardedFlowState`` (stacked [D, S] keys, [D, S, W]
    regs and, when mitigated, the stacked action tables) -> the port's
    ``ShardedFlowState``, table d on ``devices[d]`` (a device may repeat),
    for ``ShardedPacketServeEngine(..., state=)`` to resume."""
    from repro_torch.serve.sharded import ShardedFlowState

    keys, regs = np.asarray(state.keys), np.asarray(state.regs)
    if len(devices) != len(keys):
        raise ValueError(f"{len(keys)} shards, {len(devices)} devices")
    spec = spec_from_reference(state.spec)
    mit = state.mit_spec
    tables = []
    for d, dev in enumerate(devices):
        t = state_from_numpy(keys[d], regs[d], spec, device=dev)
        if mit is not None:
            t = mitigation_from_numpy(
                t, np.asarray(state.mit_keys)[d],
                np.asarray(state.mit_regs)[d],
                mitigation_spec_from_reference(mit))
        tables.append(t)
    return ShardedFlowState(tables)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 ones too, by their bits) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def _stack_to_layers(params, dev: torch.device) -> dict:
    """A tree in the reference's LM layout (``embed``, ``final_norm``,
    ``decoder/slot{i}`` stacked over the periods; ``encoder``,
    ``enc_norm``) with any nested leaves -> the port's layout: layer p *
    P + i is slot i of period p."""
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else _tensor(t, dev))

    def first(t):
        return first(next(iter(t.values()))) if isinstance(t, dict) else t

    def layer(t, i):
        if isinstance(t, dict) and set(t) == {"vr", "vc"} \
                and t["vr"].dim() == t["vc"].dim() == 1:
            # Adafactor's factored moment of a stacked [n, d] leaf: a
            # layer's row of vr; the stack's vc on its first layer
            # (``optim.adafactor``'s layout)
            return ({"vr": t["vr"][i], "vc": t["vc"]} if i == 0
                    else {"vr": t["vr"][i]})
        return ({k: layer(v, i) for k, v in t.items()}
                if isinstance(t, dict) else t[i])

    def layers(stack):
        stacked = [tree(stack[f"slot{i}"]) for i in range(len(stack))]
        n_p = len(first(stacked[0]))
        return [layer(s, p) for p in range(n_p) for s in stacked]

    out = {"embed": tree(params["embed"]),
           "final_norm": tree(params["final_norm"]),
           "layers": layers(params["decoder"])}
    if "encoder" in params:
        out["encoder"] = layers(params["encoder"])
        out["enc_norm"] = tree(params["enc_norm"])
    return out


def lm_params_from_reference(params, *, device="cuda", experts=None) -> dict:
    """The reference's scan-stacked LM parameter tree (numpy leaves:
    ``embed``, ``final_norm`` and, per slot ``decoder/slot{i}``, leaves
    stacked over the periods; an encdec's ``encoder/slot{i}`` and
    ``enc_norm`` too) -> the port's tree (``models.transformer``: layer
    p * P + i is slot i of period p; cross-attention trees with their
    ``gate``, mLSTM and sLSTM trees as they are), dtypes and layouts
    kept, so every value is a copy.  ``experts`` (a contiguous run of expert ids,
    None: all) keeps only those experts' ``wg``/``wu``/``wd`` of each MoE
    layer.  Each layer's tensors are views of its slot's stacked
    tensors."""
    def held(t):
        if not isinstance(t, dict):
            return t
        if "router" in t:          # an MoE layer: the held experts only
            lo, hi = expert_range(experts, np.shape(t["router"])[-1])
            return {k: v if k == "router" else np.asarray(v)[:, lo:hi]
                    for k, v in t.items()}
        return {k: held(v) for k, v in t.items()}

    return _stack_to_layers(held(params), resolve_device(device))


def trained_from_reference(trained, *, n_inputs: int | None = None,
                           device="cuda") -> mlalgos.TrainedModel:
    """A reference ``TrainedModel`` (read by its fields: ``algorithm``,
    numpy ``params``, ``topology``, ``num_classes``, ``config``) -> the
    port's, whose ``predict`` runs on ``device`` (a DNN/logreg forward)
    or in numpy (the others), so codegen and dispatch can be held to the
    same parameters in both packages.  ``n_inputs``: a kmeans model's
    input width when it uses a feature subset (the reference's topology
    does not carry it; default the centroids' width)."""
    algo = str(trained.algorithm)
    topo, params = trained.topology, trained.params
    config = dict(trained.config)
    if algo in ("dnn", "logreg"):
        layers = [{"w": _f32(l["w"]), "b": _f32(l["b"])} for l in params]
        return mlalgos.dnn_model(layers, list(topo["widths"]),
                                 int(trained.num_classes), config,
                                 algorithm=algo, device=device)
    if algo == "kmeans":
        fi = topo.get("feature_idx")
        return mlalgos.kmeans_model(
            _f32(params["centroids"]),
            np.asarray(params["label_map"], np.int32),
            None if fi is None else list(fi), int(trained.num_classes),
            config, n_inputs=n_inputs)
    if algo == "svm":
        return mlalgos.svm_model(_f32(params["W"]), _f32(params["b"]), config)
    if algo == "tree":
        return mlalgos.tree_model([dict(n) for n in topo["nodes"]],
                                  int(topo["depth"]),
                                  int(trained.num_classes), config)
    raise NotImplementedError(f"algorithm {algo!r}")


def dataset_from_reference(d) -> Dataset:
    """A reference ``netdata.Dataset`` (read by its fields) -> the
    port's, the arrays as numpy."""
    return Dataset(str(d.name), np.asarray(d.train_x),
                   np.asarray(d.train_y), np.asarray(d.test_x),
                   np.asarray(d.test_y), list(d.feature_names),
                   int(d.num_classes))


def fused_from_reference(fused, *, device="cuda"):
    """A reference ``fusion.FusedModel`` -> the port's, with its numpy
    params (trunk and heads) and its datasets carried across."""
    from repro_torch.core.fusion import FusedModel

    params = {part: [{"w": _f32(l["w"]), "b": _f32(l["b"])}
                     for l in fused.params[part]]
              for part in ("trunk", "heads")}
    return FusedModel([int(w) for w in fused.trunk_widths],
                      [int(h) for h in fused.heads], params,
                      [dataset_from_reference(d) for d in fused.datasets],
                      device=device)


def report_from_reference(rep):
    """A reference ``FeasibilityReport`` -> the port's."""
    from repro_torch.core.feasibility import FeasibilityReport

    return FeasibilityReport(bool(rep.feasible), list(rep.reasons),
                             dict(rep.resources), float(rep.latency_ns),
                             float(rep.throughput_pps))


def result_from_reference(result, *, device="cuda"):
    """A reference ``dse.GenerationResult`` -> the port's.  Each
    reference object (``ModelResult``, trained model, pipeline, report)
    maps to ONE port object, so leaves that share a trained model or a
    pipeline in the reference share it in the port too.  Pipelines
    compile for ``"cuda"`` (a reference ``"pallas"`` pipeline) or
    ``"interpret"`` on ``device``; a result's BO history keeps each
    observation's config, value and feasibility."""
    from repro_torch.core import bo, codegen, dse

    memo: dict[int, object] = {}

    def once(obj, make):
        if id(obj) not in memo:
            memo[id(obj)] = make(obj)
        return memo[id(obj)]

    def trained(t):
        return trained_from_reference(t, device=device)

    def pipeline(p):
        return codegen.Pipeline(
            str(p.name), str(p.backend), str(p.algorithm),
            stages_from_reference(p.stages), str(p.source),
            once(p.report, report_from_reference), once(p.model, trained),
            exec_backend="interpret" if p.exec_backend == "interpret"
            else "cuda", device=device)

    def model_result(r):
        return dse.ModelResult(
            name=str(r.name), algorithm=str(r.algorithm),
            trained=once(r.trained, trained),
            pipeline=once(r.pipeline, pipeline),
            report=once(r.report, report_from_reference),
            value=float(r.value), metric=str(r.metric),
            history=[bo.Observation(dict(o.config), float(o.value),
                                    bool(o.feasible), {})
                     for o in r.history],
            regret=[float(x) for x in r.regret], wall_s=float(r.wall_s))

    return dse.GenerationResult(
        platform_kind=str(result.platform_kind),
        models={name: once(r, model_result)
                for name, r in result.models.items()},
        dag_report=(None if result.dag_report is None
                    else report_from_reference(result.dag_report)),
        schedule=str(result.schedule))


def train_state_from_reference(state, *, device="cuda") -> dict:
    """The reference's ``init_train_state`` tree (numpy leaves: params,
    the AdamW ``m`` / ``v`` or the Adafactor ``f`` tree of ``vr`` / ``vc``
    / ``v``, ``step``) -> the port's ``train.step`` state on ``device``:
    params through ``lm_params_from_reference``, the moments unstacked the
    same way, every value a copy."""
    dev = resolve_device(device)
    opt = state["opt"]
    if "f" in opt:
        opt = {"f": _stack_to_layers(opt["f"], dev)}
    else:
        opt = {"m": _stack_to_layers(opt["m"], dev),
               "v": _stack_to_layers(opt["v"], dev)}
    return {"params": lm_params_from_reference(state["params"], device=dev),
            "opt": opt,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
