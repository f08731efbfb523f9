"""Stage IR (counterpart of ``repro.core.stageir``): the typed stage list
a trained pipeline lowers into, with PyTorch ``apply`` forms.

Ported: the stateless stages (FeatureSelect, Dense, FusedMLP,
FusedClassify, CentroidDistance, Quantize, LUTGather, TreeTraverse,
Reduce, LabelMap), the stateful vocabulary of the flow path (FlowKey,
RegisterUpdate, WindowStats, Mitigate), the single- and multi-table
stateful grammars (``split_stateful``, ``split_stateful_multi``),
``compile_stages`` with its backend reporting, and the accounting half:
each stage's ``meta()``, ``stage_summary`` and the shape-only
``StageSpec`` lowering (``lower_topology``, ``flowstate_specs``,
``mitigation_specs``) the feasibility models read before anything is
trained.  One difference from the JAX package: a kmeans MAT is charged
the entries its LUT holds (every input feature's table, the topology's
``n_inputs``), where the JAX lowering charges only the features the
centroids use.

Stages keep their parameters as numpy arrays (what ``convert`` carries
across from the reference); ``apply`` moves them to the input's device
once and reuses that copy.  As in the JAX package, ``FusedMLP.apply`` and
``FusedClassify.apply`` run the MLP kernel ops (K5 logits, K3 classify,
``kernels.fused_mlp``) for a model within the JAX package's kernel
envelope (every width at most ``PALLAS_LANE``), even inside a plain stage
walk; ``apply_plain`` is their plain PyTorch form.  Every other ``apply``
is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flow_update.ref import _M32, _mul32
from repro_torch.kernels.fused_mlp.ref import mlp_classify_ref, mlp_ref

# bucket count of the MAT range tables — single source of truth for both
# the executable lowering (codegen._quantize_tables) and the shape-only
# accounting specs below
MAT_BINS = 512

# The JAX package's MLP kernels take every width up to its 128-lane tile
# (``repro/kernels/fused_mlp/ops.py:_prepare``); wider models it walks in
# jnp, and so does the port's stage walk.
PALLAS_LANE = 128


def _param(stage, name: str, value, device, dtype):
    """``value`` as a tensor on ``device``, converted once per device."""
    cache = stage.__dict__.setdefault("_params", {})
    key = (name, str(device), dtype)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(np.asarray(value), dtype=dtype,
                                         device=device)
    return t


def _params(stage, name: str, values, device):
    return [_param(stage, f"{name}{i}", v, device, torch.float32)
            for i, v in enumerate(values)]


class Stage:
    """One typed pipeline op; ``apply`` maps a [B, F] tensor forward."""

    kind: str = "stage"
    stateful = False

    def apply(self, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_plain(self, h: torch.Tensor) -> torch.Tensor:
        """``apply`` in plain PyTorch only (no kernel op)."""
        return self.apply(h)

    def meta(self) -> dict:
        """What ``stage_summary`` charges: parameter words ("params") and
        multiply-accumulates per row ("macs"), where the stage has any."""
        return {}

    def __repr__(self):
        return f"{type(self).__name__}()"


@dataclasses.dataclass(repr=False)
class FeatureSelect(Stage):
    idx: np.ndarray                      # feature indices to keep

    kind = "feature_select"

    def apply(self, h):
        return h[:, _param(self, "idx", self.idx, h.device, torch.int64)]


@dataclasses.dataclass(repr=False)
class Dense(Stage):
    w: np.ndarray                        # [n_in, n_out]
    b: np.ndarray                        # [n_out]
    act: str | None = None               # None | "relu"

    kind = "dense"

    def apply(self, h):
        out = h @ _param(self, "w", self.w, h.device, torch.float32) \
            + _param(self, "b", self.b, h.device, torch.float32)
        return torch.relu(out) if self.act == "relu" else out

    def meta(self):
        return {"params": int(np.size(self.w) + np.size(self.b)),
                "macs": int(np.size(self.w))}


def mlp_widths(weights) -> list[int]:
    """[d_0, d_1, ..., d_L] of an MLP's weight list."""
    return [int(np.shape(weights[0])[0])] + [int(np.shape(w)[1])
                                             for w in weights]


class _MLPStage(Stage):
    """Shared by FusedMLP and FusedClassify: the packed weights, once per
    device, and whether the JAX package runs a kernel for this model."""

    weights: list
    biases: list

    def packed(self, device):
        """The weights packed for the kernels, once per device."""
        from repro_torch.kernels.fused_mlp import pack_params

        cache = self.__dict__.setdefault("_packed", {})
        key = str(device)
        if key not in cache:
            cache[key] = pack_params(self.weights, self.biases,
                                     device=device)
        return cache[key]

    def in_kernel_envelope(self) -> bool:
        return max(mlp_widths(self.weights)) <= PALLAS_LANE

    def _layers(self, device):
        return (_params(self, "w", self.weights, device),
                _params(self, "b", self.biases, device))

    def meta(self):
        return {"params": int(sum(np.size(w) + np.size(b)
                                  for w, b in zip(self.weights,
                                                  self.biases))),
                "macs": int(sum(np.size(w) for w in self.weights))}


@dataclasses.dataclass(repr=False)
class FusedMLP(_MLPStage):
    """Whole ReLU-MLP -> logits: kernel K5 (``kernels.fused_mlp.
    fused_mlp``) for a CUDA tensor within the envelope."""

    weights: list
    biases: list

    kind = "fused_mlp"

    def apply(self, h):
        from repro_torch.kernels.fused_mlp import fused_mlp_packed

        if not self.in_kernel_envelope():
            return self.apply_plain(h)
        return fused_mlp_packed(h, self.packed(h.device))

    def apply_plain(self, h):
        return mlp_ref(h, *self._layers(h.device))


@dataclasses.dataclass(repr=False)
class FusedClassify(_MLPStage):
    """FusedMLP + argmax in one kernel (K3): class ids out, no logits.
    Produced by ``fuse_pipeline_stages``."""

    weights: list
    biases: list

    kind = "fused_classify"

    def apply(self, h):
        from repro_torch.kernels.fused_mlp import fused_mlp_classify_packed

        if not self.in_kernel_envelope():
            return self.apply_plain(h)
        return fused_mlp_classify_packed(h, self.packed(h.device))

    def apply_plain(self, h):
        return mlp_classify_ref(h, *self._layers(h.device))


@dataclasses.dataclass(repr=False)
class CentroidDistance(Stage):
    centroids: np.ndarray                # [K, F']

    kind = "centroid_distance"

    def apply(self, h):
        cent = _param(self, "c", self.centroids, h.device, torch.float32)
        return torch.sum((h[:, None, :] - cent[None]) ** 2, -1)

    def meta(self):
        return {"params": int(np.size(self.centroids)),
                "macs": int(np.size(self.centroids))}


@dataclasses.dataclass(repr=False)
class Quantize(Stage):
    edges: np.ndarray                    # [F, BINS-1] sorted edges

    kind = "quantize"

    def apply(self, h):
        edges = _param(self, "e", self.edges, h.device, torch.float32)
        return torch.searchsorted(edges, h.T.contiguous(), right=False).T


@dataclasses.dataclass(repr=False)
class LUTGather(Stage):
    tables: np.ndarray                   # [F, BINS, C] per-feature partials

    kind = "lut_gather"

    def apply(self, bins):
        tables = _param(self, "t", self.tables, bins.device, torch.float32)
        f = torch.arange(tables.shape[0], device=bins.device)
        return tables[f[None, :], bins].sum(1)

    def meta(self):
        return {"params": int(np.size(self.tables))}


@dataclasses.dataclass(repr=False)
class TreeTraverse(Stage):
    """Level-synchronous CART walk: ``depth + 1`` rounds of gather and
    compare (one MAT per tree level), exact."""

    feat: np.ndarray                     # [n_nodes] split feature (0 at leaf)
    thr: np.ndarray                      # [n_nodes] f32 threshold
    left: np.ndarray                     # [n_nodes] child ids (self at leaf)
    right: np.ndarray
    leaf_class: np.ndarray               # [n_nodes] class at leaf (0 inner)
    is_leaf: np.ndarray                  # [n_nodes] bool
    depth: int

    kind = "tree_traverse"

    @classmethod
    def from_nodes(cls, nodes: list[dict], depth: int) -> "TreeTraverse":
        """Flat CART nodes (``mlalgos.train_tree``) -> the stage."""
        n = len(nodes)
        feat = np.zeros(n, np.int32)
        thr = np.zeros(n, np.float32)
        left = np.arange(n, dtype=np.int32)
        right = np.arange(n, dtype=np.int32)
        leaf_class = np.zeros(n, np.int32)
        is_leaf = np.zeros(n, bool)
        for i, nd in enumerate(nodes):
            if "leaf" in nd:
                is_leaf[i] = True
                leaf_class[i] = nd["leaf"]
            else:
                feat[i] = nd["feat"]
                thr[i] = np.float32(nd["thr"])
                left[i] = nd["left"]
                right[i] = nd["right"]
        return cls(feat, thr, left, right, leaf_class, is_leaf, depth)

    def meta(self):
        return {"params": int(len(self.feat))}

    def apply(self, h):
        dev = h.device
        feat = _param(self, "feat", self.feat, dev, torch.int64)
        thr = _param(self, "thr", self.thr, dev, torch.float32)
        left = _param(self, "left", self.left, dev, torch.int64)
        right = _param(self, "right", self.right, dev, torch.int64)
        leaf_class = _param(self, "leaf", self.leaf_class, dev, torch.int32)
        is_leaf = _param(self, "is_leaf", self.is_leaf, dev, torch.bool)
        nid = torch.zeros(h.shape[0], dtype=torch.int64, device=dev)
        for _ in range(self.depth + 1):
            x_f = torch.gather(h, 1, feat[nid][:, None])[:, 0]
            child = torch.where(x_f <= thr[nid], left[nid], right[nid])
            nid = torch.where(is_leaf[nid], nid, child)
        return leaf_class[nid]


@dataclasses.dataclass(repr=False)
class Reduce(Stage):
    op: str                              # argmax | argmin

    kind = "reduce"

    def apply(self, scores):
        fn = torch.argmax if self.op == "argmax" else torch.argmin
        return fn(scores, dim=-1).to(torch.int32)


@dataclasses.dataclass(repr=False)
class LabelMap(Stage):
    table: np.ndarray                    # [K] id -> class

    kind = "label_map"

    def apply(self, ids):
        return _param(self, "t", self.table, ids.device,
                      torch.int32)[ids.long()]


# ------------------------------------------------------ stateful vocabulary


@dataclasses.dataclass(repr=False)
class FlowKey(Stage):
    """Mix packet header columns into a non-negative int32 flow key:
    columns rounded half-to-even, cast to int32 then uint32, FNV-folded;
    the sign bit is cleared (the register file reserves -1 for empty)."""

    key_cols: tuple
    n_slots: int

    kind = "flow_key"
    stateful = True

    def apply(self, h):
        raise TypeError("FlowKey is stateful; serve it through "
                        "repro_torch.flowstate.StatefulPipeline")

    def apply_keys(self, h: torch.Tensor) -> torch.Tensor:
        """[B, F] packet rows -> [B] int32 flow keys (uint32 arithmetic in
        int64 with ``& 0xFFFFFFFF``)."""
        key = torch.zeros(h.shape[0], dtype=torch.int64, device=h.device)
        for c in self.key_cols:
            v = torch.round(h[:, c]).to(torch.int32).to(torch.int64) & _M32
            key = _mul32(key, 16777619) ^ v
        return (key & 0x7FFFFFFF).to(torch.int32)

    def apply_keys_np(self, h: np.ndarray) -> np.ndarray:
        """Numpy twin of ``apply_keys`` (same rounding, same fold) for
        host-side use: the engine's telemetry segments the batch from its
        host staging rows without touching the card."""
        h = np.asarray(h)
        key = np.zeros(h.shape[0], np.uint32)
        with np.errstate(over="ignore"):
            for c in self.key_cols:
                v = np.round(h[:, c]).astype(np.int32).astype(np.uint32)
                key = key * np.uint32(16777619) ^ v
        return (key & np.uint32(0x7FFFFFFF)).astype(np.int32)


@dataclasses.dataclass(repr=False)
class RegisterUpdate(Stage):
    """Per-flow register update.  Per packet: counter 0 += 1; counter 1+j
    += column ``counter_cols[j]``; EWMA j blends ``ewma_cols[j]``;
    histogram j bumps bucket ``searchsorted(hist_edges[j], col)``.
    ``prepare`` derives the update vectors; the stateful update itself is
    ``kernels.flow_update`` (or the fused launch)."""

    spec: object                         # flowstate.registers.FlowStateSpec
    counter_cols: tuple = ()
    ewma_cols: tuple = ()
    hist_cols: tuple = ()
    hist_edges: tuple = ()

    kind = "register_update"
    stateful = True

    def __post_init__(self):
        s = self.spec
        if s.n_counters != 1 + len(self.counter_cols):
            raise ValueError(
                f"spec.n_counters={s.n_counters} != 1 (pkt count) + "
                f"{len(self.counter_cols)} counter_cols")
        if s.n_ewma != len(self.ewma_cols):
            raise ValueError("spec.n_ewma != len(ewma_cols)")
        if len(self.hist_cols) != len(self.hist_edges):
            raise ValueError("hist_cols and hist_edges must pair up")
        sizes = tuple(len(np.asarray(e)) + 1 for e in self.hist_edges)
        if tuple(s.hist_sizes) != sizes:
            raise ValueError(
                f"spec.hist_sizes={tuple(s.hist_sizes)} != bins implied by "
                f"hist_edges {sizes}")

    def apply(self, h):
        raise TypeError("RegisterUpdate is stateful; serve it through "
                        "repro_torch.flowstate.StatefulPipeline")

    def meta(self):
        # stored key + W register words per slot (flowstate_specs)
        return {"params": self.spec.n_slots * (self.spec.width + 1)}

    def prepare(self, h: torch.Tensor):
        """[B, F] packet rows -> (upd [B, C+E] f32, bins [B, H] int32
        absolute register columns)."""
        B = h.shape[0]
        cols = [torch.ones((B, 1), dtype=torch.float32, device=h.device)]
        for c in tuple(self.counter_cols) + tuple(self.ewma_cols):
            cols.append(h[:, c:c + 1])
        upd = torch.cat(cols, 1).to(torch.float32)
        if not self.hist_cols:
            return upd, torch.full((B, 1), -1, dtype=torch.int32,
                                   device=h.device)
        offs = self.spec.hist_offsets
        bins = [
            (torch.searchsorted(
                _param(self, f"e{j}", e, h.device, torch.float32),
                h[:, c].contiguous(), right=False).to(torch.int32)
             + offs[j])[:, None]
            for j, (c, e) in enumerate(zip(self.hist_cols, self.hist_edges))
        ]
        return upd, torch.cat(bins, 1)


@dataclasses.dataclass(repr=False)
class WindowStats(Stage):
    """Registers -> windowed statistics: ``"all"`` = counters ++ EWMAs ++
    histograms / packet count; ``"hist"`` = normalised histograms only."""

    spec: object
    mode: str = "all"

    kind = "window_stats"

    def __post_init__(self):
        if self.mode not in ("all", "hist"):
            raise KeyError(f"WindowStats mode must be all|hist: {self.mode}")

    @property
    def n_out(self) -> int:
        s = self.spec
        return sum(s.hist_sizes) if self.mode == "hist" else s.width

    def apply(self, feats):
        s = self.spec
        head = s.n_counters + s.n_ewma
        denom = torch.clamp(feats[:, :1], min=1.0)   # counter 0 = count
        hist = feats[:, head:] / denom
        if self.mode == "hist":
            return hist
        return torch.cat([feats[:, :head], hist], 1)


@dataclasses.dataclass(repr=False)
class Mitigate(Stage):
    """Verdicts -> actions: the per-flow drop / rate-limit action table
    (``flowstate.mitigation``).  A flow with ``spec.threshold`` attack
    verdicts is marked and its later packets come back as ``MITIGATED``
    (or are rate-limited).  Stateful and order dependent: it must be the
    LAST stage of a stateful pipeline (``split_mitigation``), served by
    ``repro_torch.flowstate.StatefulPipeline``."""

    spec: object                         # flowstate.mitigation.MitigationSpec

    kind = "mitigate"
    stateful = True

    def apply(self, h):
        raise TypeError("Mitigate is stateful; serve it through "
                        "repro_torch.flowstate.StatefulPipeline")

    def meta(self) -> dict:
        s = self.spec
        return {"n_slots": s.n_slots, "mode": s.mode,
                "threshold": s.threshold,
                # stored key + [hits, since] per slot
                "params": s.n_slots * (s.width + 1),
                "sram_bytes": s.sram_bytes}


def is_stateful(stage: Stage) -> bool:
    return bool(getattr(stage, "stateful", False))


def split_mitigation(stages: list) -> tuple[list, Mitigate | None]:
    """Split off the trailing ``Mitigate`` stage -> (rest, mitigate|None);
    any other placement raises."""
    mits = [i for i, s in enumerate(stages) if isinstance(s, Mitigate)]
    if not mits:
        return list(stages), None
    if len(mits) > 1 or mits[0] != len(stages) - 1:
        raise ValueError(
            "Mitigate consumes verdicts and must be the single LAST "
            f"stage; got it at positions {mits} of {len(stages)} stages")
    return list(stages[:-1]), stages[-1]


def split_stateful(stages: list) -> tuple[list, list]:
    """A stateful pipeline -> ([FlowKey, RegisterUpdate], suffix); raises
    on any other arrangement or a stateful stage in the suffix."""
    if len(stages) < 2 or not isinstance(stages[0], FlowKey) \
            or not isinstance(stages[1], RegisterUpdate):
        raise ValueError(
            "stateful pipelines must start with [FlowKey, RegisterUpdate]; "
            f"got {[s.kind for s in stages[:2]]}")
    suffix = list(stages[2:])
    bad = [s.kind for s in suffix if is_stateful(s)]
    if bad:
        raise ValueError(f"stateful stages {bad} outside the prefix")
    return list(stages[:2]), suffix


def split_stateful_multi(stages: list) -> tuple[list, list]:
    """A (possibly multi-table) stateful pipeline -> (groups, suffix).

    Grammar: one or more ``FlowKey RegisterUpdate [WindowStats]`` groups
    (a ``WindowStats`` directly after a ``RegisterUpdate`` is that
    table's readout), then a stateless classifier suffix over the
    readouts concatenated in group order.  Each group is a ``(flow_key,
    register_update, window_stats | None)`` tuple; every table keys and
    updates off the same packet rows.  Raises on any other arrangement,
    with the JAX package's messages."""
    groups: list = []
    rest = list(stages)
    while rest and isinstance(rest[0], FlowKey):
        if len(rest) < 2 or not isinstance(rest[1], RegisterUpdate):
            raise ValueError(
                "each FlowKey must be followed by its RegisterUpdate; got "
                f"{[s.kind for s in rest[:2]]}")
        ws = rest[2] if len(rest) > 2 and isinstance(rest[2], WindowStats) \
            else None
        groups.append((rest[0], rest[1], ws))
        rest = rest[3 if ws is not None else 2:]
    if not groups:
        raise ValueError(
            "stateful pipelines must start with [FlowKey, RegisterUpdate]; "
            f"got {[s.kind for s in stages[:2]]}")
    bad = [s.kind for s in rest if is_stateful(s)]
    if bad:
        raise ValueError(f"stateful stages {bad} outside the table groups")
    return groups, rest


def apply_stages(stages: list, x: torch.Tensor, *, plain: bool = False
                 ) -> torch.Tensor:
    """Walk the stage list; ``plain`` takes every stage's plain PyTorch
    form (no kernel op)."""
    h = x
    for s in stages:
        h = s.apply_plain(h) if plain else s.apply(h)
    return h


def fuse_pipeline_stages(stages: list) -> list:
    """Peephole: FusedMLP -> Reduce(argmax) becomes FusedClassify."""
    out: list = []
    i = 0
    while i < len(stages):
        s = stages[i]
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        if (isinstance(s, FusedMLP) and isinstance(nxt, Reduce)
                and nxt.op == "argmax"):
            out.append(FusedClassify(s.weights, s.biases))
            i += 2
            continue
        out.append(s)
        i += 1
    return out


def unfuse_pipeline_stages(stages: list) -> list:
    """Inverse peephole: FusedClassify -> FusedMLP, Reduce(argmax) — the
    plain form the ``interpret`` backend walks (no kernel runs)."""
    out: list = []
    for s in stages:
        if isinstance(s, FusedClassify):
            out += [FusedMLP(s.weights, s.biases), Reduce("argmax")]
        else:
            out.append(s)
    return out


# ---------------------------------------------------------------- execution

EXEC_BACKENDS = ("interpret", "cuda")

# Engines a compiled artifact may REPORT serving on (what actually runs):
# the requestable engines; the whole-DAG K6 launch (``chaining.
# compile_dag``, "cuda-fused-dag"); the single-launch stateful pipeline
# (``flowstate.StatefulPipeline``, "cuda-fused-flow"); their plain forms
# on CPU tensors ("cpu-ref", "cpu-ref-fused-dag", "cpu-ref-fused-flow");
# and "mixed" for DAGs and stateful pipelines whose parts run on
# different engines.
REPORT_BACKENDS = ("interpret", "cuda", "cuda-fused-dag", "cuda-fused-flow",
                   "cpu-ref", "cpu-ref-fused-dag", "cpu-ref-fused-flow",
                   "mixed")


def kernel_backend(device: torch.device) -> str:
    """What a kernel lowering reports on ``device``: "cuda" on the card,
    "cpu-ref" where the ops run their plain versions."""
    return "cuda" if device.type == "cuda" else "cpu-ref"


class CompiledStages:
    """A stateless stage pipeline compiled for one engine and device
    (counterpart of ``repro.core.stageir.CompiledStages``): ``fn(x [B, F])
    -> verdicts or logits``.  ``backend`` is what actually serves,
    ``requested_backend`` what was asked, ``stages`` and ``fuse`` what it
    was compiled from."""

    def __init__(self, fn: Callable, backend: str, requested: str, stages,
                 fuse: bool, device: torch.device):
        self.fn = fn
        self.backend = backend
        self.requested_backend = requested
        self.stages = list(stages)
        self.fuse = fuse
        self.device = device

    def dispatch(self, x) -> torch.Tensor:
        """Launch on the pipeline's device without waiting for the result."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device,
                                                       non_blocking=True)
        return self.fn(x)

    def __call__(self, x) -> torch.Tensor:
        return self.dispatch(x)

    def __repr__(self):
        return f"CompiledStages(backend={self.backend!r})"


def compile_stages(stages: list, *, fuse: bool = True,
                   backend: str = "interpret", device="cuda"
                   ) -> CompiledStages:
    """Compile a stateless stage list for one engine (counterpart of
    ``repro.core.stageir.compile_stages``).

    * ``"interpret"``: walk the stage list (each ``Stage.apply``; like the
      JAX package's walk, the MLP stages run their kernel ops);
    * ``"cuda"``: lower the pipeline onto ONE kernel launch
      (``core.cuda_backend.lower_stages_cuda``: K3, K4 or K5) where the
      JAX package lowers it onto a Pallas kernel.  Where the JAX package
      walks it in jnp instead (a centroid or tree classifier, an MLP wider
      than ``PALLAS_LANE``), the port walks it too and reports
      ``"interpret"``.  A pipeline the JAX package lowers but the port's
      kernels cannot take raises with the reason: no quiet fallback."""
    from repro_torch.core import cuda_backend

    if backend not in EXEC_BACKENDS:
        raise KeyError(f"backend must be one of {EXEC_BACKENDS}")
    state_kinds = [s.kind for s in stages if is_stateful(s)]
    if state_kinds:
        raise ValueError(
            f"stateful stages {state_kinds} cannot be compiled statelessly; "
            "use repro_torch.flowstate.StatefulPipeline")
    dev = resolve_device(device)
    run_list = fuse_pipeline_stages(stages) if fuse else list(stages)
    if backend == "cuda" and not cuda_backend.stages_in_plain_walk(run_list):
        fn = cuda_backend.lower_stages_cuda(run_list, dev)
        if fn is None:
            raise ValueError("backend='cuda' cannot serve this pipeline: "
                             + cuda_backend.stages_decline_reason(run_list))
        return CompiledStages(fn, kernel_backend(dev), backend, stages,
                              fuse, dev)
    return CompiledStages(lambda x, _s=tuple(run_list): apply_stages(_s, x),
                          "interpret", backend, stages, fuse, dev)


class StagePipeline:
    """A stateless stage list served as a pipeline: the part of the JAX
    package's ``codegen.Pipeline`` that chaining and serving read.
    ``stages`` is the list, and a call walks it (``compile_stages`` with
    the ``"interpret"`` backend) on ``device`` -> numpy.  The kernels
    serve it through ``compile_stages``, ``chaining.compile_dag`` or
    ``PacketServeEngine(backend=...)``."""

    def __init__(self, stages, *, device="cuda"):
        self.stages = list(stages)
        self._compiled = compile_stages(self.stages, device=device)
        self.backend = self._compiled.backend
        self.device = self._compiled.device

    def dispatch(self, x) -> torch.Tensor:
        return self._compiled.dispatch(x)

    def __call__(self, x) -> np.ndarray:
        return self.dispatch(x).cpu().numpy()

    def __repr__(self):
        return (f"StagePipeline({[s.kind for s in self.stages]}, "
                f"backend={self.backend!r})")


def stage_summary(stages: list) -> dict:
    """Aggregate stage metadata (params/macs/tables) for reports."""
    params = macs = 0
    for s in stages:
        m = s.meta()
        params += m.get("params", 0)
        macs += m.get("macs", 0)
    return {"stages": [s.kind for s in stages], "params": int(params),
            "macs": int(macs)}


# ===================================================== shape-only stage specs
#
# The feasibility oracle runs before anything is trained, so it lowers a
# *topology* into StageSpecs — same vocabulary, shapes only
# (``repro/core/stageir.py:700-856``).


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str
    n_in: int = 0
    n_out: int = 0
    params: int = 0
    extra: tuple = ()                    # kind-specific (depth, bins, ...)

    @property
    def is_layer(self) -> bool:
        """Does this spec occupy compute as one dense layer (CU rows)?"""
        return self.kind in ("dense", "centroid_distance")


def lower_topology(algorithm: str, topology: dict, *, form: str = "dense"
                   ) -> list[StageSpec]:
    """Topology dict -> abstract stage list for one backend family.

    ``form="dense"``: Taurus/FPGA/GPU MapReduce lowering.
    ``form="mat"``:   IIsy-style match-action-table lowering.
    """
    if form == "dense":
        return _lower_dense(algorithm, topology)
    if form == "mat":
        return _lower_mat(algorithm, topology)
    raise KeyError(form)


def _dense_layers(widths) -> list[StageSpec]:
    w = list(widths)
    return [StageSpec("dense", w[i], w[i + 1], w[i] * w[i + 1] + w[i + 1])
            for i in range(len(w) - 1)]


def _tree_spec(topology: dict) -> StageSpec:
    return StageSpec("tree_traverse", 0, 0, len(topology["nodes"]),
                     extra=(topology.get("depth", 8),))


def _lower_dense(algorithm: str, topology: dict) -> list[StageSpec]:
    if algorithm in ("dnn", "logreg"):
        return _dense_layers(topology["widths"]) + [StageSpec("reduce")]
    if algorithm == "svm":
        f, c = topology["n_features"], topology["n_classes"]
        return [StageSpec("dense", f, c, f * c + c), StageSpec("reduce")]
    if algorithm == "kmeans":
        f, k = topology["n_features"], topology["k"]
        return [StageSpec("centroid_distance", f, k, f * k),
                StageSpec("reduce"), StageSpec("label_map", k, k)]
    if algorithm == "tree":
        return [_tree_spec(topology)]
    raise KeyError(f"dense lowering does not map {algorithm}")


def _lut_specs(f: int, c: int, bins: int) -> list[StageSpec]:
    return [StageSpec("quantize", f, f, extra=(bins,)),
            StageSpec("lut_gather", f, c, f * bins * c, extra=(bins,)),
            StageSpec("reduce")]


def _lower_mat(algorithm: str, topology: dict, bins: int = MAT_BINS
               ) -> list[StageSpec]:
    if algorithm == "svm":
        return _lut_specs(topology["n_features"], topology["n_classes"], bins)
    if algorithm == "logreg":
        w = topology["widths"]
        return _lut_specs(w[0], w[-1], bins)
    if algorithm == "kmeans":
        # the executable LUT holds one table per INPUT feature
        # (codegen._quantize_tables; unused features' tables are zero), so
        # the charge is n_inputs x bins x k, not n_features x bins x k
        f = topology.get("n_inputs", topology["n_features"])
        k = topology["k"]
        return _lut_specs(f, k, bins) + [StageSpec("label_map", k, k)]
    if algorithm == "tree":
        return [_tree_spec(topology)]
    if algorithm == "dnn":
        # N2Net-style: each dense layer burns ~12 MATs; keep the dense
        # shapes so the accounting can read layer count
        return _dense_layers(topology["widths"]) + [StageSpec("reduce")]
    raise KeyError(f"MAT lowering does not map {algorithm}")


def flowstate_specs(spec, *, mode: str = "all") -> list[StageSpec]:
    """Shape-only specs for the stateful prefix + readout — what the
    feasibility oracle charges for the register file.  ``params`` of the
    register_update spec is the table's word count (stored key + W
    register words per slot), equal to ``RegisterUpdate.meta()``'s."""
    W = spec.width
    n_out = sum(spec.hist_sizes) if mode == "hist" else W
    return [
        StageSpec("flow_key", n_in=0, n_out=1, extra=(spec.n_slots,)),
        StageSpec("register_update", n_in=W, n_out=W,
                  params=spec.n_slots * (W + 1), extra=(spec.n_slots, W)),
        StageSpec("window_stats", n_in=W, n_out=n_out),
    ]


def mitigation_specs(spec) -> list[StageSpec]:
    """Shape-only spec for the mitigation action table; ``params`` is the
    table's word count (stored key + [hits, since] per slot), equal to
    ``Mitigate.meta()``'s."""
    W = spec.width
    return [StageSpec("mitigate", n_in=1, n_out=1,
                      params=spec.n_slots * (W + 1),
                      extra=(spec.n_slots, W))]


def spec_layers(specs: list[StageSpec]) -> list[tuple[int, int]]:
    """(n_in, n_out) of every compute layer — what Taurus maps to CU rows."""
    return [(s.n_in, s.n_out) for s in specs if s.is_layer]


def spec_params(specs: list[StageSpec]) -> int:
    return sum(s.params for s in specs)
