"""Backend code generators (paper §3.3; counterpart of
``repro.core.codegen``): templates -> full pipelines.

Each backend lowers a ``TrainedModel`` into the typed stage IR
(``core.stageir``) and emits two artifacts:

  1. an *executable* pipeline: ``Pipeline`` compiles its stage list with
     ``stageir.compile_stages`` for ``exec_backend`` (default ``"cuda"``)
     on ``device``.  On the card a Taurus DNN/logreg/SVM pipeline is one
     K3 launch per batch (``kernels/fused_mlp``), a MAT pipeline one K4
     launch (``kernels/mat_lut``); centroid and tree classifiers are
     walked in plain PyTorch and reported ``"interpret"``, as the JAX
     package walks them in jnp.  ``compiled_backend`` records what
     serves;
  2. *source text* in the target's idiom (Spatial-like / P4-like),
     rendered from the same templates as the JAX package's, byte for
     byte for the same trained parameters.

``verify()`` checks artifact (1) against ``TrainedModel.predict`` on
held-out data.  The kernels sum in another order than the trained
model's forward, so a row whose top-two score margin is within
``MARGIN`` may flip: such rows are counted apart (``mismatches``) and
not held against the pipeline.  MAT pipelines are quantization-bounded
as in the JAX package (``verify(..., max_mismatch_frac=0.03)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import stageir
from repro_torch.core.feasibility import FeasibilityReport
from repro_torch.core.mlalgos import TrainedModel
from repro_torch.core.stageir import (
    CentroidDistance,
    Dense,
    FeatureSelect,
    FusedMLP,
    LabelMap,
    LUTGather,
    Quantize,
    Reduce,
    Stage,
    TreeTraverse,
)

# a verdict may differ from the trained model's where the model's top two
# class scores lie within this margin (the port's parity rule,
# repro_torch.testing.MARGIN)
MARGIN = 1e-4

# ------------------------------------------------------------- pipeline IR


@dataclasses.dataclass
class Pipeline:
    """A generated data-plane ML pipeline: a typed stage list plus the
    executable compiled from it.

    ``backend`` is the *hardware target* the source text is rendered for
    (taurus/tofino/fpga/gpu); ``exec_backend`` is the *execution engine*
    the stage list is compiled with (``"cuda"`` or ``"interpret"``, see
    ``stageir.compile_stages``) on ``device``; ``compiled_backend``
    records the engine that actually serves: ``"cuda"`` on the kernels,
    ``"interpret"`` for a classifier the JAX package walks too,
    ``"cpu-ref"`` for the kernels' plain versions on CPU tensors.
    ``backend="cuda"`` on a pipeline the kernels cannot take raises."""

    name: str
    backend: str                        # taurus | tofino | fpga | gpu
    algorithm: str
    stages: list[Stage]                 # the IR every backend lowers into
    source: str                         # generated Spatial/P4 text
    report: FeasibilityReport
    model: TrainedModel
    exec_backend: str = "cuda"
    device: object = "cuda"
    compiled_backend: str = dataclasses.field(init=False, default="")

    def __post_init__(self):
        self._compiled = stageir.compile_stages(
            self.stages, backend=self.exec_backend, device=self.device)
        self.device = self._compiled.device
        self.compiled_backend = self._compiled.backend

    @property
    def requested_backend(self) -> str:
        """What ``serve.PacketServeEngine`` compiles the stages for."""
        return self.exec_backend

    def dispatch(self, X) -> torch.Tensor:
        """Launch the compiled pipeline on its device without waiting for
        the verdicts (the overlap-serving path)."""
        return self._compiled.dispatch(X)

    def run(self, X: np.ndarray) -> np.ndarray:
        return self.dispatch(np.asarray(X, np.float32)).cpu().numpy() \
            .astype(np.int32)

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return self.run(X)

    def mismatches(self, X: np.ndarray) -> tuple[int, int]:
        """-> (rows where the pipeline and ``TrainedModel.predict`` differ
        outside the margin rule, rows that differ inside it).  The margin
        is the model's top-two class score gap (``TrainedModel.scores``;
        a model without scores has no row inside it)."""
        X = np.asarray(X, np.float32)
        differ = np.asarray(self(X)) != np.asarray(self.model.predict(X))
        if self.model.scores is None or not differ.any():
            return int(differ.sum()), 0
        top = np.sort(np.asarray(self.model.scores(X), np.float64), 1)
        if top.shape[1] < 2:
            return int(differ.sum()), 0
        gap = top[:, -1] - top[:, -2] if self.algorithm != "kmeans" \
            else top[:, 1] - top[:, 0]
        near = gap <= MARGIN
        return int((differ & ~near).sum()), int((differ & near).sum())

    def verify(self, X: np.ndarray, *, max_mismatch_frac: float = 0.0
               ) -> float:
        """Fraction of rows where pipeline != TrainedModel.predict outside
        the margin rule; raises past ``max_mismatch_frac``."""
        outside, _ = self.mismatches(X)
        frac = outside / max(len(X), 1)
        if frac > max_mismatch_frac:
            raise AssertionError(
                f"pipeline {self.name}: {frac:.4f} mismatch vs model "
                f"(allowed {max_mismatch_frac})"
            )
        return frac

    def stage_summary(self) -> dict:
        return stageir.stage_summary(self.stages)


# ---------------------------------------------------------- Taurus backend


_SPATIAL_HEADER = """\
// auto-generated by homunculus :: taurus backend
// app: {name}   algorithm: {algo}
// resources: {res}
Accel {{
  val packet_in  = StreamIn[PacketVec]({fin} features)
  val class_out  = StreamOut[UInt8]
"""


def _spatial_dnn(name: str, widths: list[int], res: dict) -> str:
    """Render the paper's Fig.-5 template stack: dot product -> layer ->
    pipeline with double-buffered SRAM between layers."""
    src = _SPATIAL_HEADER.format(
        name=name, algo="dnn", res=res, fin=widths[0]
    )
    for i in range(len(widths) - 1):
        n_in, n_out = widths[i], widths[i + 1]
        act = "max(acc + b, 0)" if i < len(widths) - 2 else "acc + b"
        src += f"""
  // layer {i}: [{n_in} -> {n_out}]  (map x reduce-tree dot products)
  val W{i} = SRAM[Fix16]({n_in}, {n_out}) // on-chip weights
  val B{i} = SRAM[Fix16]({n_out})
  val buf{i} = SRAM[Fix16]({n_out}).doubleBuffer
  Foreach({n_out} by 1 par {min(n_out, 16)}) {{ j =>
    val acc = Reduce(Reg[Fix16])({n_in} by 1 par 8) {{ i =>
      x{i}(i) * W{i}(i, j)
    }}{{_+_}}
    val b = B{i}(j)
    buf{i}(j) = {act}
  }}
"""
    src += f"""
  class_out := argmax(buf{len(widths) - 2})
}}
"""
    return src


def _spatial_linear(name: str, algo: str, shape: tuple[int, int], res: dict
                    ) -> str:
    n_in, n_out = shape
    head = _SPATIAL_HEADER.format(name=name, algo=algo, res=res, fin=n_in)
    body_op = "score" if algo != "kmeans" else "negdist"
    agg = "argmax" if algo != "kmeans" else "argmin"
    return head + f"""
  val W = SRAM[Fix16]({n_in}, {n_out})
  val S = SRAM[Fix16]({n_out})
  Foreach({n_out} by 1 par {min(n_out, 16)}) {{ j =>
    S(j) = Reduce(Reg[Fix16])({n_in} by 1 par 8) {{ i => {body_op}(i, j) }}{{_+_}}
  }}
  class_out := {agg}(S)
}}
"""


def taurus_stages(trained: TrainedModel) -> list[Stage]:
    """Lower a TrainedModel into the dense (MapReduce) stage form."""
    algo = trained.algorithm
    if algo in ("dnn", "logreg"):
        weights = [np.asarray(l["w"]) for l in trained.params]
        biases = [np.asarray(l["b"]) for l in trained.params]
        return [FusedMLP(weights, biases), Reduce("argmax")]
    if algo == "svm":
        return [
            Dense(np.asarray(trained.params["W"]),
                  np.asarray(trained.params["b"])),
            Reduce("argmax"),
        ]
    if algo == "kmeans":
        cent = np.asarray(trained.params["centroids"])
        lmap = np.asarray(trained.params["label_map"])
        fi = trained.topology.get("feature_idx")
        stages: list[Stage] = []
        if fi is not None:
            stages.append(FeatureSelect(np.asarray(fi, np.int32)))
        stages += [CentroidDistance(cent), Reduce("argmin"), LabelMap(lmap)]
        return stages
    raise KeyError(f"taurus backend does not map {algo}")


def taurus_codegen(name: str, trained: TrainedModel,
                   report: FeasibilityReport,
                   backend: str = "taurus",
                   exec_backend: str = "cuda", device="cuda") -> Pipeline:
    algo = trained.algorithm
    stages = taurus_stages(trained)
    if algo in ("dnn", "logreg"):
        src = _spatial_dnn(name, trained.topology["widths"], report.resources)
    elif algo == "svm":
        src = _spatial_linear(
            name, "svm", trained.params["W"].shape, report.resources
        )
    else:  # kmeans
        cent = trained.params["centroids"]
        src = _spatial_linear(
            name, "kmeans", (cent.shape[1], cent.shape[0]), report.resources
        )
    return Pipeline(name, backend, algo, stages, src, report, trained,
                    exec_backend=exec_backend, device=device)


# ------------------------------------------------------------- MAT backend
#
# IIsy-style: quantize each feature into BINS buckets (range tables); per
# feature a MAT maps bucket -> per-class partial score; a final stage adds
# partials and takes argmax/argmin.  The stage list below is the exact
# dataflow of those tables.  The bucket count is owned by the IR so the
# accounting specs (stageir.lower_topology) can never desync from it.

MAT_BINS = stageir.MAT_BINS


def _quantize_tables(trained: TrainedModel, train_x: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """-> (edges [F, BINS-1], tables [F, BINS, C], label_map, use_min)."""
    algo = trained.algorithm
    F = train_x.shape[1]
    lo = train_x.min(0) - 1e-3
    hi = train_x.max(0) + 1e-3
    edges = np.stack(
        [np.linspace(lo[f], hi[f], MAT_BINS + 1)[1:-1] for f in range(F)]
    )
    centers = np.stack(
        [
            np.concatenate([
                [(lo[f] + edges[f, 0]) / 2],
                (edges[f, :-1] + edges[f, 1:]) / 2,
                [(edges[f, -1] + hi[f]) / 2],
            ])
            for f in range(F)
        ]
    )  # [F, BINS]
    if algo == "svm":
        W, b = trained.params["W"], trained.params["b"]
        C = W.shape[1]
        tables = centers[:, :, None] * W[:, None, :]  # [F, BINS, C]
        tables[0] += b[None, :] / 1.0
        return edges, tables.astype(np.float32), np.arange(C), False
    if algo == "kmeans":
        cent = trained.params["centroids"]  # [K, F']
        fi = trained.topology.get("feature_idx")
        idx = list(range(F)) if fi is None else list(fi)
        K = cent.shape[0]
        tables = np.zeros((F, MAT_BINS, K), np.float32)
        for out_f, f in enumerate(idx):
            diff = centers[f][:, None] - cent[None, :, out_f]
            tables[f] = diff**2
        return edges, tables, trained.params["label_map"], True
    if algo == "logreg":
        W = trained.params[0]["w"]
        b = trained.params[0]["b"]
        C = W.shape[1]
        tables = centers[:, :, None] * np.asarray(W)[:, None, :]
        tables[0] += np.asarray(b)[None, :]
        return edges, tables.astype(np.float32), np.arange(C), False
    raise KeyError(f"MAT backend does not map {algo}")


_P4_HEADER = """\
// auto-generated by homunculus :: MAT backend (IIsy-style)
// app: {name}  algorithm: {algo}  tables: {mats}
"""


def _p4_tables(name: str, algo: str, F: int, C: int, mats: int) -> str:
    src = _P4_HEADER.format(name=name, algo=algo, mats=mats)
    for f in range(F):
        src += f"""
table score_f{f} {{
  key = {{ meta.feature_{f}_bin : exact; }}
  actions = {{ add_partial_scores; }}   // {C} per-class partials
  size = {MAT_BINS};
}}"""
    tail = "argmin" if algo == "kmeans" else "argmax"
    src += f"""
apply {{
  bin_features.apply();           // range -> bucket (TCAM)
  {'; '.join(f'score_f{f}.apply()' for f in range(F))};
  meta.class = {tail}(meta.partials);
}}
"""
    return src


def mat_stages(trained: TrainedModel, train_x: np.ndarray) -> list[Stage]:
    """Lower a TrainedModel into the MAT (quantized-LUT) stage form."""
    algo = trained.algorithm
    if algo == "tree":
        return [TreeTraverse.from_nodes(
            trained.topology["nodes"], trained.topology.get("depth", 8)
        )]
    edges, tables, label_map, use_min = _quantize_tables(trained, train_x)
    stages: list[Stage] = [
        Quantize(edges),
        LUTGather(tables),
        Reduce("argmin" if use_min else "argmax"),
        LabelMap(np.asarray(label_map, np.int32)),
    ]
    return stages


def mat_codegen(name: str, trained: TrainedModel,
                report: FeasibilityReport, train_x: np.ndarray,
                backend: str = "tofino",
                exec_backend: str = "cuda", device="cuda") -> Pipeline:
    algo = trained.algorithm
    stages = mat_stages(trained, train_x)
    if algo == "tree":
        nodes = trained.topology["nodes"]
        src = _P4_HEADER.format(name=name, algo="tree", mats=len(nodes))
        src += "// one MAT per level; keys = (node_id, feature cmp result)\n"
        for d in range(trained.topology.get("depth", 8)):
            src += (
                f"table level_{d} {{ key = {{ meta.node: exact; "
                f"meta.cmp: exact; }} actions = {{ goto_child; set_class; }} }}\n"
            )
        return Pipeline(name, backend, algo, stages, src, report, trained,
                        exec_backend=exec_backend, device=device)

    tables = next(s for s in stages if isinstance(s, LUTGather)).tables
    F, _, C = tables.shape
    src = _p4_tables(name, algo, F, C, int(report.resources.get("mats", F)))
    return Pipeline(name, backend, algo, stages, src, report, trained,
                    exec_backend=exec_backend, device=device)


# -------------------------------------------------------------- dispatcher


def generate_pipeline(platform_kind: str, name: str, trained: TrainedModel,
                      report: FeasibilityReport,
                      train_x: np.ndarray,
                      exec_backend: str = "cuda", device="cuda") -> Pipeline:
    if platform_kind in ("taurus", "gpu", "fpga"):
        # Taurus / FPGA / GPU all execute the dense MapReduce form; FPGA and
        # GPU reuse the Taurus templates (Spatial targets both, paper §4)
        return taurus_codegen(name, trained, report, backend=platform_kind,
                              exec_backend=exec_backend, device=device)
    if platform_kind == "tofino":
        return mat_codegen(name, trained, report, train_x,
                           exec_backend=exec_backend, device=device)
    raise KeyError(platform_kind)
