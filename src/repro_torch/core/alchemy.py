"""Alchemy: the embedded DSL and front end of Homunculus (paper §3.1;
counterpart of ``repro.core.alchemy``).

Constructs (paper Table 1):

  Model({...})            objectives, algorithm list, data loader (or a
                          bare name, for a DAG over pipelines that a
                          result mapping supplies)
  @DataLoader             dataset loading/preprocessing wrapper
  Platforms.Taurus() ...  backend target + resource/performance constraints
  a > b                   sequential composition
  a | b                   parallel composition
  platform < {...}        constraint operator (sugar for .constrain)
  IOMap / @IOMapper       wiring between composed models

A program is the paper's Figure-3 shape::

    from repro_torch import facade
    from repro_torch.core.alchemy import DataLoader, Model, Platforms

    @DataLoader
    def wrapper_func():
        ...
        return {"data": {"train": tnx, "test": tsx},
                "labels": {"train": tny, "test": tsy}}

    model_spec = Model({"optimization_metric": ["f1"],
                        "algorithm": ["dnn"],
                        "name": "anomaly_detection",
                        "data_loader": wrapper_func})
    platform = Platforms.Taurus()
    platform.constrain(performance={"throughput": 1, "latency": 500},
                       resources={"rows": 16, "cols": 16})
    platform.schedule(model_spec)
    facade.generate(platform)

Composition is binary.  Python evaluates ``a > b > c`` as ``(a > b) and
(b > c)``; the JAX package intercepts that through a frame hook on
``Seq.__bool__``.  The port writes ``(a > b) > c``: a ``Seq`` on the left
extends itself, as a ``Par`` does with ``|``.  ``Seq.__bool__`` raises,
so an unparenthesised chain fails instead of silently keeping only its
last pair.

The platforms are the JAX package's Taurus, Tofino and FPGA targets on
the copied resource models, and ``GPUPlatform`` (``Platforms.GPU``) in
place of its TPU target, on ``feasibility.GPUModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import feasibility as feas
from repro_torch.data.netdata import Dataset

# ----------------------------------------------------------------- loaders


def DataLoader(fn: Callable) -> Callable:
    """Decorator: normalize a user loader to a ``Dataset``.

    Accepts either a ``Dataset`` or the paper's dict form
    {"data": {"train", "test"}, "labels": {"train", "test"}}.
    """

    def wrapper(*a, **kw) -> Dataset:
        out = fn(*a, **kw)
        if isinstance(out, Dataset):
            return out
        data, labels = out["data"], out["labels"]
        tnx = np.asarray(data["train"], np.float32)
        tsx = np.asarray(data["test"], np.float32)
        tny = np.asarray(labels["train"], np.int32)
        tsy = np.asarray(labels["test"], np.int32)
        ncls = int(max(tny.max(), tsy.max())) + 1
        names = out.get(
            "feature_names", [f"f{i}" for i in range(tnx.shape[1])]
        )
        return Dataset(
            name=out.get("name", fn.__name__),
            train_x=tnx, train_y=tny, test_x=tsx, test_y=tsy,
            feature_names=list(names), num_classes=ncls,
        )

    wrapper.__wrapped__ = fn
    wrapper._is_dataloader = True
    return wrapper


def IOMapper(io_ins: list[str], io_outs: list[str]) -> Callable:
    """Decorator: declare a mapping function's input/output port names."""

    def deco(fn):
        fn._io_ins = list(io_ins)
        fn._io_outs = list(io_outs)
        return fn

    return deco


@dataclasses.dataclass
class IOMap:
    """Connects model inputs/outputs (paper Table 1)."""

    mapper_func: Callable  # (features, upstream_outputs) -> features

    def __call__(self, features, upstream):
        return self.mapper_func(features, upstream)


def passthrough_iomap(features, upstream):
    return features


# ------------------------------------------------------------ composition


class _Composable:
    def __gt__(self, other):              # a > b: sequential
        return Seq([self, _as_node(other)])

    def __or__(self, other):              # a | b: parallel
        return Par([self, _as_node(other)])


def _as_node(x):
    if isinstance(x, (Seq, Par, Model)):
        return x
    raise TypeError(f"cannot compose {type(x)}")


def _leaves(children) -> list:
    out = []
    for c in children:
        out += c.leaves()
    return out


def _describe(children, sep: str) -> str:
    return sep.join(f"({c.describe()})" if isinstance(c, (Seq, Par))
                    else c.name for c in children)


@dataclasses.dataclass
class Seq(_Composable):
    children: list

    def __gt__(self, other):
        return Seq(self.children + [_as_node(other)])

    def __bool__(self):
        raise TypeError("a > b > c needs parentheses in the port: write "
                        "(a > b) > c")

    def leaves(self) -> list:
        return _leaves(self.children)

    def describe(self) -> str:
        return _describe(self.children, " > ")


@dataclasses.dataclass
class Par(_Composable):
    children: list

    def __or__(self, other):
        return Par(self.children + [_as_node(other)])

    def leaves(self) -> list:
        return _leaves(self.children)

    def describe(self) -> str:
        return _describe(self.children, " | ")


# ------------------------------------------------------------------- Model


class Model(_Composable):
    """User intent for one data-plane ML model (paper §3.1.1): a spec
    dict with ``name``, ``optimization_metric``, ``algorithm`` and
    ``data_loader``.  A bare name makes a model with no intent, which
    names a pipeline of a result mapping in a DAG (``chaining``)."""

    def __init__(self, spec: dict | str):
        if isinstance(spec, str):
            spec = {"name": spec}
        self.spec = dict(spec)
        self.name: str = str(spec.get("name", "model"))
        self.metrics: list[str] = list(spec.get("optimization_metric", ["f1"]))
        self.algorithms: list[str] | None = (
            list(spec["algorithm"]) if spec.get("algorithm") else None
        )
        loader = spec.get("data_loader")
        if loader is not None and not getattr(loader, "_is_dataloader",
                                              False):
            loader = DataLoader(loader)
        self._loader = loader
        self._data: Dataset | None = None
        self.iomap: IOMap = IOMap(passthrough_iomap)

    @property
    def objective(self) -> str:
        return self.metrics[0]

    def data(self) -> Dataset:
        if self._loader is None:
            raise ValueError(f"model {self.name!r} has no data_loader")
        if self._data is None:
            self._data = self._loader()
        return self._data

    def with_iomap(self, iomap: IOMap) -> "Model":
        self.iomap = iomap
        return self

    def leaves(self) -> list:
        return [self]

    def describe(self) -> str:
        return self.name

    def __repr__(self):
        return f"Model({self.name!r})"


# --------------------------------------------------------------- Platforms


class Platform:
    """A physical data-plane target + its constraints (paper Table 1)."""

    kind: str = "abstract"

    def __init__(self):
        self.performance: dict[str, float] = {}
        self.resources: dict[str, float] = {}
        self.scheduled = None  # Model | Seq | Par
        self.generated = None  # filled by dse.generate

    # -- constraint API: .constrain(...) and the paper's `<` operator
    def constrain(self, performance: dict | None = None,
                  resources: dict | None = None, **kw):
        performance = performance or kw.get("performance") or {}
        resources = resources or kw.get("resources") or {}
        self.performance.update(performance)
        self.resources.update(resources)
        self._apply_resources()
        return self

    def __lt__(self, cons: dict):
        return self.constrain(
            performance=cons.get("performance"),
            resources=cons.get("resources"),
        )

    def _apply_resources(self):
        pass

    def schedule(self, node):
        """Install a Model or a composition DAG on this platform."""
        self.scheduled = _as_node(node)
        return self

    # -- constraint targets (None = unconstrained)
    @property
    def min_throughput_pps(self) -> float | None:
        thr = self.performance.get("throughput")
        return thr * 1e9 if thr is not None else None  # paper unit: GPkt/s

    @property
    def max_latency_ns(self) -> float | None:
        return self.performance.get("latency")  # paper unit: ns

    # -- to be provided per platform
    def check(self, algorithm: str, topology: dict) -> feas.FeasibilityReport:
        raise NotImplementedError

    def check_batch(self, algorithm: str, topologies: list[dict]
                    ) -> list[feas.FeasibilityReport]:
        """Feasibility verdicts for a whole candidate batch (Taurus reads
        the stage metadata of the entire batch in one numpy pass); the
        base form maps ``check``."""
        return [self.check(algorithm, t) for t in topologies]

    def supported_algorithms(self) -> list[str]:
        raise NotImplementedError


class TaurusPlatform(Platform):
    kind = "taurus"

    def __init__(self):
        super().__init__()
        self.model = feas.TaurusModel()

    def _apply_resources(self):
        r = self.resources
        self.model = feas.TaurusModel(
            rows=int(r.get("rows", self.model.rows)),
            cols=int(r.get("cols", self.model.cols)),
        )

    def supported_algorithms(self) -> list[str]:
        return ["dnn", "logreg", "svm", "kmeans"]

    def check(self, algorithm, topology) -> feas.FeasibilityReport:
        return self._verdict(self.model.estimate(algorithm, topology))

    def check_batch(self, algorithm, topologies
                    ) -> list[feas.FeasibilityReport]:
        return [self._verdict(est)
                for est in self.model.estimate_batch(algorithm, topologies)]

    def _verdict(self, est: dict) -> feas.FeasibilityReport:
        budget_cu = self.model.total_cu
        budget_mu = self.model.total_mu
        min_thr = self.min_throughput_pps
        max_lat = self.max_latency_ns
        # pick the lowest-II (highest-throughput) option that fits; the
        # CU <-> II tradeoff is the paper's "loop iterations vs line rate"
        for opt in est["options"]:
            fits = opt["cu"] <= budget_cu and opt["mu"] <= budget_mu
            fast = min_thr is None or opt["throughput_pps"] >= min_thr
            slow = max_lat is not None and opt["latency_ns"] > max_lat
            if fits and fast and not slow:
                return feas.FeasibilityReport(
                    True, [],
                    {"cu": opt["cu"], "mu": opt["mu"], "ii": opt["ii"]},
                    opt["latency_ns"], opt["throughput_pps"],
                )
        o = est["options"][0]
        reasons = []
        if o["cu"] > budget_cu:
            reasons.append(f"CU {o['cu']} > {budget_cu}")
        if o["mu"] > budget_mu:
            reasons.append(f"MU {o['mu']} > {budget_mu}")
        if min_thr is not None and o["throughput_pps"] < min_thr:
            reasons.append("throughput below line rate at feasible II")
        if max_lat is not None and o["latency_ns"] > max_lat:
            reasons.append(f"latency {o['latency_ns']}ns > {max_lat}ns")
        if not reasons:
            reasons.append("no II in 1..max_ii satisfies all constraints")
        return feas.FeasibilityReport(
            False, reasons, {"cu": o["cu"], "mu": o["mu"], "ii": o["ii"]},
            o["latency_ns"], o["throughput_pps"],
        )


class TofinoPlatform(Platform):
    kind = "tofino"

    def __init__(self):
        super().__init__()
        self.model = feas.MATModel()

    def _apply_resources(self):
        r = self.resources
        self.model = feas.MATModel(
            num_tables=int(r.get("tables", self.model.num_tables)),
        )

    def supported_algorithms(self) -> list[str]:
        return ["kmeans", "svm", "tree", "logreg"]

    def check(self, algorithm, topology) -> feas.FeasibilityReport:
        mats = self.model.mats_for(algorithm, topology)
        lat = mats * self.model.stage_ns
        thr = self.model.line_rate_pps
        reasons = []
        if mats > self.model.num_tables:
            reasons.append(f"MATs {mats} > {self.model.num_tables}")
        if self.max_latency_ns is not None and lat > self.max_latency_ns:
            reasons.append(f"latency {lat}ns > {self.max_latency_ns}ns")
        if (self.min_throughput_pps is not None
                and thr < self.min_throughput_pps):
            reasons.append("line rate below required throughput")
        return feas.FeasibilityReport(
            not reasons, reasons, {"mats": mats}, lat, thr
        )


class FPGAPlatform(Platform):
    kind = "fpga"

    def __init__(self):
        super().__init__()
        self.model = feas.FPGAModel()

    def _apply_resources(self):
        r = self.resources
        self.model = feas.FPGAModel(
            total_luts=int(r.get("luts", self.model.total_luts)),
            total_ffs=int(r.get("ffs", self.model.total_ffs)),
            total_bram=int(r.get("bram", self.model.total_bram)),
        )

    def supported_algorithms(self) -> list[str]:
        return ["dnn", "logreg", "svm", "kmeans", "tree"]

    def check(self, algorithm, topology) -> feas.FeasibilityReport:
        e = self.model.estimate(algorithm, topology)
        reasons = []
        if e["luts"] > self.model.total_luts:
            reasons.append(f"LUTs {e['luts']} > {self.model.total_luts}")
        if e["ffs"] > self.model.total_ffs:
            reasons.append(f"FFs {e['ffs']} > {self.model.total_ffs}")
        if self.max_latency_ns is not None and e["latency_ns"] > self.max_latency_ns:
            reasons.append(f"latency {e['latency_ns']:.0f}ns > {self.max_latency_ns}ns")
        if (self.min_throughput_pps is not None
                and e["throughput_pps"] < self.min_throughput_pps):
            reasons.append("clock-limited throughput below requirement")
        return feas.FeasibilityReport(
            not reasons, reasons,
            {"luts": e["luts"], "ffs": e["ffs"], "bram": e["bram"]},
            e["latency_ns"], e["throughput_pps"],
        )


class GPUPlatform(Platform):
    """This repository's GPU target (counterpart of the JAX package's
    ``TPUPlatform``): the generated pipeline served per batch by the
    port's MLP kernel on an H100 (``feasibility.GPUModel``)."""

    kind = "gpu"

    def __init__(self):
        super().__init__()
        self.model = feas.GPUModel()

    def _apply_resources(self):
        r = self.resources
        self.model = feas.GPUModel(
            smem_bytes=int(r.get("smem_bytes", self.model.smem_bytes)),
            batch=int(r.get("batch", self.model.batch)),
        )

    def supported_algorithms(self) -> list[str]:
        return ["dnn", "logreg", "svm", "kmeans"]

    def check(self, algorithm, topology) -> feas.FeasibilityReport:
        e = self.model.estimate(algorithm, topology)
        reasons = []
        if e["envelope"] is not None:
            reasons.append(f"outside the MLP kernels: {e['envelope']}")
        if e["smem_bytes"] > self.model.smem_bytes:
            reasons.append(
                f"shared memory {e['smem_bytes']} > {self.model.smem_bytes}")
        if self.max_latency_ns is not None and e["latency_ns"] > self.max_latency_ns:
            reasons.append(f"latency {e['latency_ns']:.0f}ns > {self.max_latency_ns}ns")
        if (self.min_throughput_pps is not None
                and e["throughput_pps"] < self.min_throughput_pps):
            reasons.append(
                f"throughput {e['throughput_pps']:.2e} pps "
                f"< {self.min_throughput_pps:.2e}"
            )
        return feas.FeasibilityReport(
            not reasons, reasons,
            {"smem_bytes": e["smem_bytes"], "staged": int(e["staged"])},
            e["latency_ns"], e["throughput_pps"],
        )


class Platforms:
    """Factory namespace, as the paper spells it: Platforms.Taurus()."""

    Taurus = TaurusPlatform
    Tofino = TofinoPlatform
    FPGA = FPGAPlatform
    GPU = GPUPlatform
