"""Random-forest surrogate, from scratch (numpy).

A copy of ``repro.core.surrogate``, kept in the port so that it imports
nothing of the reference package; the same seed grows the same forest.

The paper's §5 setup: "we setup HyperMapper to use the Random Forests
surrogate model, which is known to work well with systems workloads that
require modeling of discrete parameters and non-continuous functions".
sklearn is not available offline, so this is a compact CART-regression
forest: variance-reduction splits, bootstrap rows, feature subsampling.
``predict`` returns (mean, std) across trees — the uncertainty the EI
acquisition consumes — matching the SMAC/HyperMapper convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feat: int = -1
    thr: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = False


class RegressionTree:
    def __init__(self, *, max_depth: int = 12, min_leaf: int = 2,
                 feature_frac: float = 0.8, rng: np.random.Generator = None):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.feature_frac = feature_frac
        self.rng = rng or np.random.default_rng(0)
        self.nodes: list[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self.nodes = []
        self._build(X, y, np.arange(len(X)), 0)
        return self

    def _build(self, X, y, idx, depth) -> int:
        node_id = len(self.nodes)
        self.nodes.append(_Node())
        ys = y[idx]
        if (depth >= self.max_depth or len(idx) < 2 * self.min_leaf
                or ys.std() < 1e-12):
            self.nodes[node_id] = _Node(value=float(ys.mean()), is_leaf=True)
            return node_id

        n_feat = X.shape[1]
        k = max(1, int(round(n_feat * self.feature_frac)))
        feats = self.rng.choice(n_feat, size=k, replace=False)
        best = (None, None, np.inf)
        for f in feats:
            vals = X[idx, f]
            if vals.max() - vals.min() < 1e-12:
                continue
            # candidate thresholds: random midpoints (extra-trees style —
            # cheap and adds the diversity RF needs for useful std)
            cuts = self.rng.uniform(vals.min(), vals.max(), size=8)
            for thr in cuts:
                m = vals <= thr
                nl = int(m.sum())
                if nl < self.min_leaf or len(idx) - nl < self.min_leaf:
                    continue
                yl, yr = ys[m], ys[~m]
                score = nl * yl.var() + (len(idx) - nl) * yr.var()
                if score < best[2]:
                    best = (int(f), float(thr), score)
        if best[0] is None:
            self.nodes[node_id] = _Node(value=float(ys.mean()), is_leaf=True)
            return node_id
        f, thr, _ = best
        m = X[idx, f] <= thr
        l_id = self._build(X, y, idx[m], depth + 1)
        r_id = self._build(X, y, idx[~m], depth + 1)
        self.nodes[node_id] = _Node(feat=f, thr=thr, left=l_id, right=r_id)
        return node_id

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X), np.float64)
        for i, row in enumerate(X):
            nid = 0
            while not self.nodes[nid].is_leaf:
                nd = self.nodes[nid]
                nid = nd.left if row[nd.feat] <= nd.thr else nd.right
            out[i] = self.nodes[nid].value
        return out


class RandomForest:
    """Bootstrap ensemble; predict -> (mean, std across trees)."""

    def __init__(self, *, n_trees: int = 24, max_depth: int = 12,
                 min_leaf: int = 2, feature_frac: float = 0.8, seed: int = 0):
        self.n_trees = n_trees
        self.kw = dict(max_depth=max_depth, min_leaf=min_leaf,
                       feature_frac=feature_frac)
        self.seed = seed
        self.trees: list[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        self.trees = []
        n = len(X)
        for t in range(self.n_trees):
            boot = rng.integers(0, n, size=n)
            tree = RegressionTree(rng=np.random.default_rng(rng.integers(2**31)),
                                  **self.kw)
            tree.fit(X[boot], y[boot])
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        preds = np.stack([t.predict(X) for t in self.trees])  # [T, N]
        return preds.mean(0), preds.std(0) + 1e-9

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """For 0/1 targets: clipped mean vote = P(class 1) (feasibility)."""
        mean, _ = self.predict(X)
        return np.clip(mean, 0.0, 1.0)
