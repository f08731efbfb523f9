"""Multi-application DAGs (paper §5.1.3, Table 3; counterpart of
``repro.core.chaining``): a DAG of models composed with ``>`` / ``|``
(``core.alchemy``) executed over packets.

Semantics: every packet traverses the DAG.  A ``Seq`` gates: rows flagged
by an earlier model (verdict > 0) keep that verdict, the others take the
next model's.  A ``Par`` runs every child and merges the verdicts:
``"or"`` is the max, ``"and"`` the min, ``"concat"`` stacks them.

  ``run_dag``      the eager reference: each model's pipeline called on
                   its own, verdicts merged in numpy;
  ``compile_dag``  the whole DAG as one callable: ONE K6 launch per batch
                   when the DAG is kernel-eligible (``backend="cuda"``,
                   reported ``"cuda-fused-dag"`` on every model),
                   otherwise each model compiled by ``compile_stages``
                   and the gate a ``torch.where``.

The result is ``{name: pipeline}`` where a pipeline has ``.stages`` (and
is callable for ``run_dag``), as ``convert.pipelines_from_reference``
builds it, or a ``dse.GenerationResult``.

The Table-3 accounting reads the result's reports and stage lists, with
the reference's identical-model dedup (a model counted once however many
leaves name it):

  ``dag_resources``      the leaves' ``FeasibilityReport``s merged, one
                         per distinct trained model (``id(r.trained)``);
  ``dag_stage_summary``  stages, params and MACs summed over the distinct
                         pipelines (``id(pipe)``);
  ``strategy_table``     one row per chaining strategy: resources,
                         latency and throughput.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import cuda_backend, stageir
from repro_torch.core.alchemy import Model, Par, Seq
from repro_torch.core.cuda_backend import pipeline_of
from repro_torch.device import resolve_device

COMBINES = ("or", "and", "concat")


def run_dag(node, result, X, *, combine: str = "or") -> np.ndarray:
    """Every packet through the DAG, one pipeline at a time -> verdicts
    (numpy).  ``compile_dag`` is the compiled equivalent."""
    if combine not in COMBINES:
        raise KeyError(f"combine must be one of {COMBINES}")
    X = np.asarray(X, np.float32)

    def eval_node(n) -> np.ndarray:
        if isinstance(n, Model):
            return np.asarray(pipeline_of(result, n.name)(X))
        if isinstance(n, Seq):
            out = None
            for c in n.children:
                nxt = eval_node(c)
                out = nxt if out is None else np.where(out > 0, out, nxt)
            return out
        if isinstance(n, Par):
            outs = [eval_node(c) for c in n.children]
            if combine == "or":
                return functools.reduce(np.maximum, outs)
            if combine == "and":
                return functools.reduce(np.minimum, outs)
            return np.stack(outs, -1)
        raise TypeError(type(n))

    return eval_node(node)


class CompiledDag:
    """A whole DAG compiled for one engine and device.  ``model_backends``
    records what serves each model ("cuda-fused-dag" = the whole DAG as
    one K6 launch, "cuda" = the model's own kernel launch, "interpret" =
    its stage walk; "cpu-ref…" for the plain versions on CPU tensors);
    ``backend`` sums them up ("mixed" when they differ).
    ``fallback_reason`` says why a requested fused DAG was not fused."""

    def __init__(self, fn: Callable, schedule: str, n_models: int,
                 model_backends: dict, device: torch.device,
                 requested: str, rebuild: Callable,
                 fallback_reason: str | None = None):
        self.fn = fn
        self.schedule = schedule
        self.n_models = n_models
        self.model_backends = model_backends
        self.device = device
        self.requested_backend = requested
        self.fallback_reason = fallback_reason
        self._rebuild = rebuild

    @property
    def backend(self) -> str:
        kinds = set(self.model_backends.values()) or {"interpret"}
        return kinds.pop() if len(kinds) == 1 else "mixed"

    @property
    def fused_dag(self) -> bool:
        """True when the whole DAG serves as one K6 launch."""
        return self.backend.endswith("-fused-dag")

    def with_backend(self, backend: str, device=None) -> "CompiledDag":
        """Recompile the same DAG for another engine (and device)."""
        return self._rebuild(backend,
                             self.device if device is None else device)

    def dispatch(self, X) -> torch.Tensor:
        """Launch on the DAG's device without waiting for the result."""
        x = torch.as_tensor(X, dtype=torch.float32).to(self.device,
                                                       non_blocking=True)
        return self.fn(x)

    def __call__(self, X) -> np.ndarray:
        return self.dispatch(X).cpu().numpy()

    def __repr__(self):
        return (f"CompiledDag({self.schedule!r}, models={self.n_models}, "
                f"backend={self.backend!r})")


def compile_dag(node, result, *, combine: str = "or", fuse: bool = True,
                backend: str = "interpret", fuse_dag: bool = True,
                device="cuda") -> CompiledDag:
    """Compile the whole DAG into one callable on ``device``.

    ``backend="cuda"`` first tries ONE K6 launch for the whole DAG
    (``cuda_backend.lower_dag_cuda``); ``fuse_dag=False`` skips that (the
    per-model-launch baseline).  Otherwise each model is compiled by
    ``stageir.compile_stages`` for ``backend`` (one kernel launch where
    the JAX package has a kernel, its stage walk where the JAX package
    walks it too) and the gating runs as tensor operations, with no host
    sync."""
    if combine not in COMBINES:
        raise KeyError(f"combine must be one of {COMBINES}")
    if backend not in stageir.EXEC_BACKENDS:
        raise KeyError(f"backend must be one of {stageir.EXEC_BACKENDS}")
    dev = resolve_device(device)
    describe = node.describe() if hasattr(node, "describe") else str(node)
    n_models = len(node.leaves())

    def rebuild(b: str, d) -> CompiledDag:
        return compile_dag(node, result, combine=combine, fuse=fuse,
                           backend=b, fuse_dag=fuse_dag, device=d)

    reason = None
    if backend == "cuda" and fuse_dag:
        dag_fn = cuda_backend.lower_dag_cuda(node, result, dev,
                                             combine=combine, fuse=fuse)
        if dag_fn is not None:
            name = stageir.kernel_backend(dev) + "-fused-dag"
            return CompiledDag(dag_fn, describe, n_models,
                               {m.name: name for m in node.leaves()}, dev,
                               backend, rebuild)
        reason = cuda_backend.dag_decline_reason(node, result,
                                                 combine=combine, fuse=fuse)

    model_backends: dict[str, str] = {}

    def lower(n) -> Callable:
        if isinstance(n, Model):
            compiled = stageir.compile_stages(
                pipeline_of(result, n.name).stages, fuse=fuse,
                backend=backend, device=dev)
            model_backends[n.name] = compiled.backend
            return compiled.fn
        if isinstance(n, Seq):
            branches = [lower(c) for c in n.children]

            def seq_fn(x, _b=tuple(branches)):
                out = _b[0](x)
                for b in _b[1:]:
                    out = torch.where(out > 0, out, b(x))
                return out

            return seq_fn
        if isinstance(n, Par):
            branches = [lower(c) for c in n.children]

            def par_fn(x, _b=tuple(branches)):
                outs = [b(x) for b in _b]
                if combine == "or":
                    return functools.reduce(torch.maximum, outs)
                if combine == "and":
                    return functools.reduce(torch.minimum, outs)
                return torch.stack(outs, -1)

            return par_fn
        raise TypeError(type(n))

    return CompiledDag(lower(node), describe, n_models, model_backends, dev,
                       backend, rebuild, fallback_reason=reason)


# ----------------------------------------------------------- accounting


def dag_resources(node, result):
    """Table-3 accounting: identical models counted once (shared
    weights) -> the merged ``FeasibilityReport``."""
    seen: set[int] = set()
    rep = None
    for m in node.leaves():
        r = result[m.name]
        if id(r.trained) in seen:
            continue
        seen.add(id(r.trained))
        rep = r.report if rep is None else rep.merge(r.report)
    if rep is None:
        raise ValueError("a DAG without leaves has no resources")
    return rep


def dag_stage_summary(node, result) -> dict:
    """Stage metadata over the DAG with identical-model dedup — the same
    dedup rule as dag_resources, read off the pipelines' stage lists."""
    seen: set[int] = set()
    total = {"stages": [], "params": 0, "macs": 0}
    for m in node.leaves():
        pipe = pipeline_of(result, m.name)
        if id(pipe) in seen:
            continue
        seen.add(id(pipe))
        s = stageir.stage_summary(pipe.stages)
        total["stages"] += s["stages"]
        total["params"] += s["params"]
        total["macs"] += s["macs"]
    return total


def strategy_table(strategies: dict, result) -> list[dict]:
    """One row per chaining strategy: {strategy, cu/mu or mats, ...}."""
    rows = []
    for name, node in strategies.items():
        rep = dag_resources(node, result)
        row = {"strategy": name, **rep.resources}
        row["latency_ns"] = round(rep.latency_ns, 1)
        row["throughput_pps"] = rep.throughput_pps
        rows.append(row)
    return rows
