"""Design-space definition for the optimization core (paper §3.2.2).

A copy of ``repro.core.designspace`` (numpy only), kept in the port so that
it imports nothing of the reference package; the same generator draws the
same configurations in both.

Variables can be real (continuous), integer, ordinal, or categorical — the
exact taxonomy of HyperMapper [68] that the paper adopts.  Per-algorithm
spaces are produced by ``algorithm_space`` with bounds derived from the
target platform (the paper: "bounds ... typically calculated based on the
target being considered").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    kind: str                       # real | int | ordinal | categorical
    low: float = 0.0                # real/int bounds
    high: float = 1.0
    values: tuple = ()              # ordinal/categorical choices
    log: bool = False               # sample/encode in log space

    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind in ("ordinal", "categorical"):
            return self.values[rng.integers(0, len(self.values))]
        if self.kind == "real":
            if self.log:
                return float(np.exp(rng.uniform(
                    math.log(self.low), math.log(self.high))))
            return float(rng.uniform(self.low, self.high))
        if self.kind == "int":
            return int(rng.integers(int(self.low), int(self.high) + 1))
        raise ValueError(self.kind)

    def encode(self, v: Any) -> float:
        """Map a value to [0, 1] for the surrogate."""
        if self.kind == "categorical":
            return self.values.index(v) / max(len(self.values) - 1, 1)
        if self.kind == "ordinal":
            return self.values.index(v) / max(len(self.values) - 1, 1)
        lo, hi = self.low, self.high
        if self.log:
            return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (float(v) - lo) / (hi - lo) if hi > lo else 0.0


@dataclasses.dataclass
class DesignSpace:
    params: list[Param]

    @property
    def names(self) -> list[str]:
        return [p.name for p in self.params]

    def sample(self, rng: np.random.Generator) -> dict:
        return {p.name: p.sample(rng) for p in self.params}

    def sample_n(self, rng: np.random.Generator, n: int) -> list[dict]:
        return [self.sample(rng) for _ in range(n)]

    def encode(self, config: dict) -> np.ndarray:
        return np.array([p.encode(config[p.name]) for p in self.params],
                        np.float32)

    def encode_batch(self, configs: Sequence[dict]) -> np.ndarray:
        return np.stack([self.encode(c) for c in configs])

    def size_estimate(self) -> float:
        """log10 of the (discretized) space cardinality, for reporting."""
        total = 0.0
        for p in self.params:
            if p.kind in ("ordinal", "categorical"):
                total += math.log10(len(p.values))
            elif p.kind == "int":
                total += math.log10(max(p.high - p.low + 1, 1))
            else:
                total += math.log10(64)  # ~6 bits of useful resolution
        return total


# ----------------------------------------------- per-algorithm design spaces

MAX_DNN_LAYERS = 10  # paper's BD winner: "10 hidden layers" — allow that depth


def algorithm_space(algorithm: str, *, n_features: int, num_classes: int,
                    max_neurons: int = 64) -> DesignSpace:
    """The tunable-parameter space per supported algorithm (paper §3.2.2:
    hyperparameters incl. NAS variables; resource/network constraints enter
    through the feasibility oracle, not the space itself)."""
    if algorithm == "dnn":
        neuron_choices = tuple(
            v for v in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
            if v <= max_neurons
        )
        params = [
            Param("n_layers", "int", 1, MAX_DNN_LAYERS),
            Param("lr", "real", 3e-4, 3e-2, log=True),
            Param("batch", "ordinal", values=(128, 256, 512)),
            Param("epochs", "ordinal", values=(8, 12, 16)),
        ]
        params += [
            Param(f"h{i}", "ordinal", values=neuron_choices)
            for i in range(MAX_DNN_LAYERS)
        ]
        return DesignSpace(params)
    if algorithm == "kmeans":
        return DesignSpace([
            Param("k", "int", 1, max(num_classes * 3, 2)),
            Param("n_features", "int", min(2, n_features), n_features),
        ])
    if algorithm == "svm":
        return DesignSpace([
            Param("c_reg", "real", 0.01, 100.0, log=True),
        ])
    if algorithm == "tree":
        return DesignSpace([
            Param("max_depth", "int", 2, 10),
        ])
    if algorithm == "logreg":
        return DesignSpace([
            Param("lr", "real", 1e-2, 1.0, log=True),
        ])
    raise KeyError(algorithm)
