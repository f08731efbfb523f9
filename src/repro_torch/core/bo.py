"""Constrained Bayesian optimization (paper §3.2.3–§3.2.4).

A copy of ``repro.core.bo`` (numpy only) over the port's copies of the
design space and the surrogate; the same seed and observations give the
same suggestions in both.

HyperMapper-style: uniform-random initialization phase, then iterate
    fit RF surrogate on observed (x, y)
    fit RF feasibility classifier on observed (x, feasible)
    candidate pool <- random sample of the design space
    pick argmax  EI(x) * P(feasible | x)          [Gelbart et al., cEI]
The objective is treated as a noisy black box: the BO never sees model
internals, only (config -> metric, feasible) pairs — exactly the paper's
formulation ("we cannot access other information than the output y ...
given an input value x").

``suggest_batch(k)`` is the population-parallel form the batched DSE racer
consumes: q-EI approximated by greedy Kriging-believer fantasies — pick the
cEI argmax, pretend its outcome equals the surrogate mean, refit, pick the
next — so the k proposals spread instead of piling onto one optimum.  Both
the batched and the sequential evaluation paths consume the same proposal
stream, which is what makes them comparable run-for-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core.designspace import DesignSpace
from repro_torch.core.surrogate import RandomForest


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float
                         ) -> np.ndarray:
    """EI for maximization, closed form under a Gaussian posterior."""
    z = (mu - best) / sigma
    # standard normal pdf / cdf without scipy
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + _erf(z / math.sqrt(2.0)))
    return (mu - best) * cdf + sigma * pdf


def _erf(x: np.ndarray) -> np.ndarray:
    # Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7) — scipy-free erf
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-x * x))


@dataclasses.dataclass
class Observation:
    config: dict
    value: float          # objective (maximize); NaN if evaluation failed
    feasible: bool
    info: dict


class ConstrainedBO:
    """suggest()/observe() driver.  Maximizes; infeasible points contribute
    to the feasibility model but not the objective surrogate."""

    def __init__(
        self,
        space: DesignSpace,
        *,
        n_init: int = 10,
        candidates_per_iter: int = 512,
        seed: int = 0,
        rf_kwargs: dict | None = None,
    ):
        self.space = space
        self.n_init = n_init
        self.n_cand = candidates_per_iter
        self.rng = np.random.default_rng(seed)
        self.rf_kwargs = rf_kwargs or {}
        self.history: list[Observation] = []

    # ------------------------------------------------------------- state

    @property
    def feasible_history(self) -> list[Observation]:
        return [o for o in self.history
                if o.feasible and np.isfinite(o.value)]

    @property
    def best(self) -> Observation | None:
        feas = self.feasible_history
        return max(feas, key=lambda o: o.value) if feas else None

    def regret_curve(self) -> list[float]:
        """Best feasible objective so far, per iteration (paper Fig. 4)."""
        out, best = [], -np.inf
        for o in self.history:
            if o.feasible and np.isfinite(o.value):
                best = max(best, o.value)
            out.append(best)
        return out

    # ----------------------------------------------------------- suggest

    def suggest(self) -> dict:
        if len(self.history) < self.n_init:
            return self.space.sample(self.rng)

        feas = self.feasible_history
        cands = self.space.sample_n(self.rng, self.n_cand)
        Xc = self.space.encode_batch(cands)

        # feasibility model over every observation
        p_feas = np.ones(len(cands))
        if any(not o.feasible for o in self.history):
            Xf = self.space.encode_batch([o.config for o in self.history])
            yf = np.array([1.0 if o.feasible else 0.0 for o in self.history])
            clf = RandomForest(seed=int(self.rng.integers(2**31)),
                               **self.rf_kwargs).fit(Xf, yf)
            p_feas = clf.predict_proba(Xc)

        if len(feas) < 2:
            # not enough signal for the objective surrogate: chase feasibility
            return cands[int(np.argmax(p_feas + 1e-3 * self.rng.random(len(cands))))]

        Xo = self.space.encode_batch([o.config for o in feas])
        yo = np.array([o.value for o in feas])
        rf = RandomForest(seed=int(self.rng.integers(2**31)),
                          **self.rf_kwargs).fit(Xo, yo)
        mu, sigma = rf.predict(Xc)
        ei = expected_improvement(mu, sigma, yo.max())
        score = ei * p_feas
        return cands[int(np.argmax(score))]

    def suggest_batch(self, k: int) -> list[dict]:
        """Propose k configurations at once (q-EI via greedy fantasies).

        Init phase: k uniform-random samples.  Too little feasible signal:
        the top-k of the feasibility-probability ranking.  Otherwise the
        Kriging-believer loop: argmax cEI, append (x, mu(x)) as a fantasy
        observation, refit the surrogate, repeat — each refit sees the
        fantasies, so successive picks explore away from each other.
        """
        if k <= 0:
            return []
        if len(self.history) < self.n_init:
            return self.space.sample_n(self.rng, k)

        feas = self.feasible_history
        cands = self.space.sample_n(self.rng, self.n_cand)
        Xc = self.space.encode_batch(cands)

        p_feas = np.ones(len(cands))
        if any(not o.feasible for o in self.history):
            Xf = self.space.encode_batch([o.config for o in self.history])
            yf = np.array([1.0 if o.feasible else 0.0 for o in self.history])
            clf = RandomForest(seed=int(self.rng.integers(2**31)),
                               **self.rf_kwargs).fit(Xf, yf)
            p_feas = clf.predict_proba(Xc)

        if len(feas) < 2:
            score = p_feas + 1e-3 * self.rng.random(len(cands))
            top = np.argsort(-score)[:k]
            return [cands[int(i)] for i in top]

        Xo = self.space.encode_batch([o.config for o in feas])
        yo = np.array([o.value for o in feas])
        X_fit, y_fit = Xo, yo
        avail = np.ones(len(cands), bool)
        picked: list[dict] = []
        for _ in range(min(k, len(cands))):
            rf = RandomForest(seed=int(self.rng.integers(2**31)),
                              **self.rf_kwargs).fit(X_fit, y_fit)
            mu, sigma = rf.predict(Xc)
            ei = expected_improvement(mu, sigma, float(y_fit.max()))
            score = np.where(avail, ei * p_feas, -np.inf)
            j = int(np.argmax(score))
            avail[j] = False
            picked.append(cands[j])
            # Kriging believer: fantasize the surrogate mean as the outcome
            X_fit = np.concatenate([X_fit, Xc[j:j + 1]])
            y_fit = np.concatenate([y_fit, mu[j:j + 1]])
        return picked

    def observe(self, config: dict, value: float, feasible: bool,
                info: dict | None = None) -> None:
        self.history.append(Observation(config, float(value), bool(feasible),
                                        info or {}))

    # ------------------------------------------------------------- drive

    def run(
        self,
        evaluate: Callable[[dict], tuple[float, bool, dict]],
        budget: int,
        *,
        callback: Callable[[int, Observation], None] | None = None,
    ) -> Observation | None:
        """Full loop: ``evaluate(config) -> (value, feasible, info)``."""
        for it in range(budget):
            cfg = self.suggest()
            value, feasible, info = evaluate(cfg)
            self.observe(cfg, value, feasible, info)
            if callback:
                callback(it, self.history[-1])
        return self.best

    def run_batched(
        self,
        evaluate_batch: Callable[[list[dict]],
                                 list[tuple[float, bool, dict]]],
        budget: int,
        *,
        batch_size: int = 8,
        callback: Callable[[int, Observation], None] | None = None,
    ) -> Observation | None:
        """Batched loop: propose ``batch_size`` configs per iteration and
        hand them to ``evaluate_batch`` (which may train them in one vmapped
        program).  Total evaluations still equal ``budget``."""
        done = 0
        while done < budget:
            cfgs = self.suggest_batch(min(batch_size, budget - done))
            for cfg, (value, feasible, info) in zip(
                    cfgs, evaluate_batch(cfgs)):
                self.observe(cfg, value, feasible, info)
                if callback:
                    callback(done, self.history[-1])
                done += 1
        return self.best
