"""The Homunculus generation driver (paper §3.2; counterpart of
``repro.core.dse``): candidate selection, BO-guided DSE, feasibility
testing, and final code generation.

``generate(platform)`` is the paper's ``homunculus.generate``
(``repro_torch.facade.generate``):

  1. flatten the scheduled Model/DAG into leaf models;
  2. per model, per candidate algorithm: build the design space (§3.2.2),
     pre-prune algorithms whose *minimal* configuration already violates the
     platform (the paper's "rule out as many algorithms as possible");
  3. race a ConstrainedBO per algorithm (the paper runs "multiple parallel
     runs", footnote 1) in interleaved rounds: each live racer proposes a
     *batch* of K configurations per round (q-EI fantasies), the batch is
     trained population-parallel (batched buckets for DNN/logreg on
     ``device``, a worker pool for the numpy algorithms, all behind the
     content-addressed
     trained-candidate cache) and feasibility-checked in one pass
     (``platform.check_batch`` reads stage metadata for the whole batch);
  4. pick the best feasible configuration across algorithms, codegen the
     pipeline (§3.3) onto the port's kernels on ``device`` (their plain
     versions where ``device`` is the CPU), attach regret curves (Fig. 4) and the
     per-iteration history.

``eval_mode="sequential"`` trains the *same proposal stream* one config at
a time through ``mlalgos.train`` — the reference path the batched engine is
held against (same best config under a fixed seed).

Multi-model scheduling: each of the n scheduled models is allocated 1/n of
the platform's resources during its own search (the paper's §5.1.3 split),
and the final DAG report merges resources with *identical-model dedup* —
chained copies of one model share weights and pipeline logic on the target,
which is why the paper's Table 3 resource count stays constant across
chaining strategies.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np

from repro_torch.core import codegen, mlalgos
from repro_torch.core.alchemy import Model, Platform
from repro_torch.core.bo import ConstrainedBO, Observation
from repro_torch.core.designspace import algorithm_space
from repro_torch.core.feasibility import FeasibilityReport
from repro_torch.core.traincache import (
    GLOBAL_CACHE,
    CandidateCache,
    candidate_key,
)
from repro_torch.device import resolve_device

# ------------------------------------------------------------------ result


@dataclasses.dataclass
class ModelResult:
    name: str
    algorithm: str
    trained: mlalgos.TrainedModel
    pipeline: codegen.Pipeline
    report: FeasibilityReport
    value: float                  # best feasible objective
    metric: str
    history: list[Observation]
    regret: list[float]
    wall_s: float

    def summary(self) -> dict:
        return {
            "name": self.name,
            "algorithm": self.algorithm,
            "metric": self.metric,
            "value": round(self.value, 4),
            "params": self.trained.param_count,
            "stages": self.pipeline.stage_summary()["stages"],
            "resources": self.report.resources,
            "latency_ns": round(self.report.latency_ns, 1),
            "throughput_pps": self.report.throughput_pps,
            "iterations": len(self.history),
        }


@dataclasses.dataclass
class GenerationResult:
    platform_kind: str
    models: dict[str, ModelResult]
    dag_report: FeasibilityReport | None
    schedule: str

    def __getitem__(self, name: str) -> ModelResult:
        return self.models[name]

    def summary(self) -> dict:
        return {
            "platform": self.platform_kind,
            "schedule": self.schedule,
            "models": {k: v.summary() for k, v in self.models.items()},
            "dag_resources": self.dag_report.resources if self.dag_report else None,
        }


# --------------------------------------------------------------- evaluate


def _metric_value(metric: str, trained: mlalgos.TrainedModel, data) -> float:
    if metric == "v_measure" and trained.algorithm == "kmeans":
        clusters = trained.topology["assign"](data.test_x)
        return mlalgos.v_measure(data.test_y, clusters)
    y_pred = trained.predict(data.test_x)
    return mlalgos.evaluate_metric(
        metric, data.test_y, y_pred, num_classes=data.num_classes
    )


def evaluate_candidates(
    platform: Platform,
    algorithm: str,
    data,
    metric: str,
    configs: list[dict],
    *,
    seed: int = 0,
    mode: str = "batched",
    cache: CandidateCache | None = GLOBAL_CACHE,
    workers: int | None = None,
    device="cuda",
) -> list[tuple[float, bool, dict]]:
    """Evaluate a whole proposal batch — the black box f of §3.2.3, one
    round at a time: resolve the trained-candidate cache, train the misses
    (``mode="batched"``: batched buckets / worker pool;
    ``mode="sequential"``: one ``mlalgos.train`` call each — the reference
    path), then feasibility-check every topology in one ``check_batch``.
    Results come back in proposal order.  ``cache``: the process-wide
    ``GLOBAL_CACHE`` by default, any private ``CandidateCache``, or ``None``
    to disable memoization; its keys carry the trainer's device type.
    ``device``: where the DNN/logreg trainer runs."""
    dev = resolve_device(device)
    keys = [
        candidate_key(algorithm, c, seed, data, device=dev.type)
        if cache is not None else None
        for c in configs
    ]
    trained: list[mlalgos.TrainedModel | None] = [
        cache.get(k) if cache is not None else None for k in keys
    ]
    # unique misses (first occurrence trains; duplicates share the result)
    miss_idx: list[int] = []
    first_of: dict[str, int] = {}
    for i, tm in enumerate(trained):
        if tm is not None:
            continue
        k = keys[i]
        if k is not None:
            if k in first_of:
                continue
            first_of[k] = i
        miss_idx.append(i)

    miss_cfgs = [configs[i] for i in miss_idx]
    if mode == "sequential":
        fresh = [mlalgos.train(algorithm, data, c, seed=seed, device=dev)
                 for c in miss_cfgs]
    elif mode == "batched":
        fresh = mlalgos.train_batch(algorithm, data, miss_cfgs, seed=seed,
                                    workers=workers, device=dev)
    else:
        raise KeyError(f"eval_mode {mode!r} (batched|sequential)")
    for i, tm in zip(miss_idx, fresh):
        trained[i] = tm
        if cache is not None:
            cache.put(keys[i], tm)
    for i, tm in enumerate(trained):
        if tm is None:  # in-batch duplicate of a fresh miss
            trained[i] = trained[first_of[keys[i]]]

    reports = platform.check_batch(
        algorithm, [tm.topology for tm in trained]
    )
    return [
        (
            _metric_value(metric, tm, data),
            rep.feasible,
            {"trained": tm, "report": rep, "params": tm.param_count},
        )
        for tm, rep in zip(trained, reports)
    ]


def _min_config(algorithm: str, space) -> dict:
    """Smallest configuration in the space (for algorithm pre-pruning)."""
    cfg = {}
    for p in space.params:
        if p.kind in ("ordinal", "categorical"):
            cfg[p.name] = p.values[0]
        elif p.kind == "int":
            cfg[p.name] = int(p.low)
        else:
            cfg[p.name] = float(p.low)
    if algorithm == "dnn":
        cfg["n_layers"] = 1
    return cfg


def _seed_configs(algorithm: str, space) -> list[dict]:
    """Small-model seeds for the BO init phase (paper §3.2.2: bounds are
    "calculated based on the target").  On tight targets a uniform-random
    init may never hit the feasible region (e.g. 30-feature DNNs at II=1 on
    a 16x16 grid); seeding a ladder of small nets anchors the feasibility
    classifier wherever a feasible model exists."""
    seeds = [_min_config(algorithm, space)]
    if algorithm == "dnn":
        base = _min_config(algorithm, space)
        for layers, width in ((1, 16), (2, 8), (2, 16), (3, 8)):
            c = dict(base)
            c["n_layers"] = layers
            for i in range(layers):
                c[f"h{i}"] = width
            seeds.append(c)
    return seeds


def _prune_algorithms(platform: Platform, algorithms: list[str], data
                      ) -> tuple[list[str], dict[str, str]]:
    """Paper §3.2.1: drop algorithms whose minimal config can't fit."""
    kept, dropped = [], {}
    for algo in algorithms:
        if algo not in platform.supported_algorithms():
            dropped[algo] = "not supported by backend"
            continue
        space = algorithm_space(
            algo, n_features=data.num_features, num_classes=data.num_classes
        )
        probe = _min_config(algo, space)
        # structural probe: topology of the minimal model without training
        topo = _probe_topology(algo, probe, data)
        rep = platform.check(algo, topo)
        if rep.feasible:
            kept.append(algo)
        else:
            dropped[algo] = "; ".join(rep.reasons)
    return kept, dropped


def _probe_topology(algo: str, cfg: dict, data) -> dict:
    F, C = data.num_features, data.num_classes
    if algo in ("dnn", "logreg"):
        hidden = (
            [cfg.get("h0", 4)] * cfg.get("n_layers", 1) if algo == "dnn" else []
        )
        return {"widths": [F] + hidden + [C], "act": "relu"}
    if algo == "kmeans":
        return {"k": cfg.get("k", 1), "n_features": cfg.get("n_features", F),
                "n_inputs": F}
    if algo == "svm":
        return {"n_features": F, "n_classes": C}
    if algo == "tree":
        d = cfg.get("max_depth", 2)
        return {"nodes": [{}] * (2 ** (d + 1) - 1), "depth": d}
    raise KeyError(algo)


# ----------------------------------------------------------------- search


@dataclasses.dataclass
class _Racer:
    """One algorithm's lane in the round-interleaved BO race."""

    algorithm: str
    bo: ConstrainedBO
    pending_seeds: list[dict]
    remaining: int
    iteration: int = 0


def search_model(
    platform: Platform,
    model: Model,
    *,
    budget: int = 30,
    n_init: int = 8,
    seed: int = 0,
    max_neurons: int = 64,
    callback=None,
    eval_mode: str = "batched",
    batch_k: int = 8,
    cache: CandidateCache | None = GLOBAL_CACHE,
    workers: int | None = None,
    device="cuda",
) -> ModelResult:
    """Run the full DSE for one Model on one platform.

    Racers are interleaved round-robin; each round a live racer proposes up
    to ``batch_k`` configs (``suggest_batch``) which are evaluated together
    by ``evaluate_candidates``.  Per-algorithm budgets and the small-model
    seed anchors match the sequential engine eval-for-eval, so regret
    curves remain comparable across modes.  ``device``: where the trainer
    runs and the pipeline serves.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    data = model.data()
    metric = model.objective
    algorithms = model.algorithms or platform.supported_algorithms()
    algorithms, dropped = _prune_algorithms(platform, algorithms, data)
    if not algorithms:
        raise RuntimeError(
            f"no candidate algorithm is feasible on {platform.kind}: {dropped}"
        )

    racers: list[_Racer] = []
    for ai, algo in enumerate(algorithms):
        space = algorithm_space(
            algo, n_features=data.num_features,
            num_classes=data.num_classes, max_neurons=max_neurons,
        )
        bo = ConstrainedBO(space, n_init=n_init, seed=seed + 17 * ai)
        algo_budget = max(4, budget // len(algorithms))
        # small-model anchors seed the history (count against the budget)
        seeds = _seed_configs(algo, space)[:max(2, algo_budget // 4)]
        racers.append(_Racer(
            algorithm=algo, bo=bo, pending_seeds=seeds,
            remaining=len(seeds) + max(algo_budget - len(seeds), 2),
        ))

    histories: list[Observation] = []
    regret: list[float] = []
    incumbent = -np.inf
    while any(r.remaining > 0 for r in racers):
        for r in racers:
            if r.remaining <= 0:
                continue
            k = min(batch_k, r.remaining)
            if r.pending_seeds:
                props = r.pending_seeds[:k]
                r.pending_seeds = r.pending_seeds[k:]
            else:
                props = r.bo.suggest_batch(k)
            outs = evaluate_candidates(
                platform, r.algorithm, data, metric, props, seed=seed,
                mode=eval_mode, cache=cache, workers=workers, device=dev,
            )
            for cfg, (value, feasible, info) in zip(props, outs):
                r.bo.observe(cfg, value, feasible, info)
                obs = r.bo.history[-1]
                histories.append(obs)
                if feasible and np.isfinite(value):
                    incumbent = max(incumbent, value)
                regret.append(incumbent)
                if callback:
                    callback(r.algorithm, r.iteration, obs)
                r.iteration += 1
            r.remaining -= len(props)

    best: tuple[float, str, Observation] | None = None
    for r in racers:
        b = r.bo.best
        if b is not None and (best is None or b.value > best[0]):
            best = (b.value, r.algorithm, b)

    if best is None:
        raise RuntimeError(
            f"{model.name}: no feasible configuration found in {budget} "
            f"iterations on {platform.kind} (constraints {platform.performance}"
            f" / {platform.resources})"
        )

    value, algo, obs = best
    trained = obs.info["trained"]
    report = obs.info["report"]
    pipeline = codegen.generate_pipeline(
        platform.kind, model.name, trained, report, data.train_x,
        exec_backend="cuda", device=dev,
    )
    return ModelResult(
        name=model.name, algorithm=algo, trained=trained,
        pipeline=pipeline, report=report, value=value, metric=metric,
        history=histories, regret=regret,
        wall_s=time.perf_counter() - t0,
    )


# ------------------------------------------------------------ generate()


def _split_platform(platform: Platform, n: int) -> Platform:
    """Allocate 1/n of the platform resources to one model (§5.1.3)."""
    if n <= 1:
        return platform
    p = copy.deepcopy(platform)
    if platform.kind == "taurus":
        p.model.rows = max(1, p.model.rows // n)
    elif platform.kind == "tofino":
        p.model.num_tables = max(1, p.model.num_tables // n)
    elif platform.kind == "fpga":
        p.model.total_luts //= n
        p.model.total_ffs //= n
    elif platform.kind == "gpu":
        p.model.smem_bytes //= n
    return p


def _dag_report(node, results: dict[str, ModelResult]) -> FeasibilityReport:
    """Merge reports over the DAG with identical-model dedup (Table 3)."""
    leaves = node.leaves()
    seen: set[int] = set()
    rep: FeasibilityReport | None = None
    for m in leaves:
        r = results[m.name]
        key = id(r.trained)
        if key in seen:
            continue  # chained copy shares weights + pipeline logic
        seen.add(key)
        rep = r.report if rep is None else rep.merge(r.report)
    assert rep is not None
    return rep


def generate(
    platform: Platform,
    *,
    budget: int = 30,
    n_init: int = 8,
    seed: int = 0,
    max_neurons: int = 64,
    callback=None,
    eval_mode: str = "batched",
    batch_k: int = 8,
    cache: CandidateCache | None = GLOBAL_CACHE,
    workers: int | None = None,
    device="cuda",
) -> GenerationResult:
    """The paper's ``homunculus.generate(platform)``: every scheduled
    model trained on ``device`` and its pipeline compiled there
    (``search_model``)."""
    assert platform.scheduled is not None, "call platform.schedule(...) first"
    node = platform.scheduled
    leaves = node.leaves()
    # dedup: chained copies of the same Model object search once
    unique: dict[int, Model] = {}
    for m in leaves:
        unique.setdefault(id(m), m)
    sub = _split_platform(platform, len(unique))

    results: dict[str, ModelResult] = {}
    for m in unique.values():
        res = search_model(
            sub, m, budget=budget, n_init=n_init, seed=seed,
            max_neurons=max_neurons, callback=callback,
            eval_mode=eval_mode, batch_k=batch_k, cache=cache,
            workers=workers, device=device,
        )
        results[m.name] = res
    # alias results for duplicate leaf names (chained copies)
    for m in leaves:
        if m.name not in results:
            twin = unique[id(m)]
            results[m.name] = results[twin.name]

    dag_rep = _dag_report(node, results)
    out = GenerationResult(
        platform_kind=platform.kind,
        models=results,
        dag_report=dag_rep,
        schedule=node.describe(),
    )
    platform.generated = out
    return out


def retrain_model(
    platform: Platform,
    data,
    *,
    name: str = "retrain",
    metric: str = "f1",
    algorithms: list[str] | None = None,
    budget: int = 12,
    n_init: int = 4,
    seed: int = 0,
    batch_k: int = 4,
    cache: CandidateCache | None = GLOBAL_CACHE,
    device="cuda",
) -> ModelResult:
    """One-shot re-search over a FRESH dataset: the online-learning hook.

    A drift loop (the JAX package's ``serve.online.BackgroundRetrainer``;
    not yet ported) hands in a Dataset
    assembled from recent drifted windows; this wraps it into a Model and
    reruns the racer with the process-wide trained-candidate cache, so
    every (algorithm, config, seed) pair whose content hash survived the
    drift — i.e. anything retrained on identical data, plus the seed
    anchors on repeat episodes — warm-starts instead of retraining.  The
    default budget is deliberately smaller than an offline ``generate``:
    a retrain races against ongoing traffic degradation, and the cache
    plus the already-narrowed algorithm list close most of the gap."""
    model = Model({
        "name": name,
        "optimization_metric": [metric],
        "algorithm": list(algorithms) if algorithms else None,
        "data_loader": lambda data=data: data,
    })
    return search_model(
        platform, model, budget=budget, n_init=n_init, seed=seed,
        batch_k=batch_k, cache=cache, device=device,
    )
