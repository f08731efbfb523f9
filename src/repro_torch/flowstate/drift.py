"""Label-free drift detection over the flow-state window statistics
(counterpart of ``repro.flowstate.drift``; numpy only, a copy of its
arithmetic: float32 window means, a float64 EWMA).

The trigger of the online-learning loop
(docs/pipeline_ir.md#hot-swap-contract): it watches the same packet
windows the serving engine micro-batches — the columns the
``RegisterUpdate`` stage folds into the per-flow window statistics — and
scores each window's feature means against a frozen training-time
snapshot.  It is host work on buffers the engine already holds at
``submit()`` time: no device launch and no labels.

The statistic: per-window column means, EWMA-smoothed across windows
(``ewma_j = (1-a)*ewma_j + a*mean_j``), scored as the max per-column
z-distance from the snapshot, where ``mu``/``sd`` are the mean and
spread of the per-window means over the training stream.  The detector
fires after ``patience`` consecutive windows above ``threshold``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftSnapshot:
    """Frozen reference: per-window feature-mean moments of the training
    stream.  ``cols`` names the packet columns the statistic watches."""

    mu: np.ndarray                 # [len(cols)] mean of per-window means
    sd: np.ndarray                 # [len(cols)] spread of per-window means
    cols: tuple

    @staticmethod
    def from_packets(packets: np.ndarray, *, cols, window: int
                     ) -> "DriftSnapshot":
        """Freeze a snapshot from the training stream's packet matrix:
        split into ``window``-sized chunks, take each chunk's column
        means, and record their mean/std.  Needs at least one full
        window; a shorter stream falls back to a single whole-stream
        window with unit spread (sane, never NaN)."""
        cols = tuple(int(c) for c in cols)
        pkts = np.asarray(packets, np.float32)
        n_win = len(pkts) // int(window)
        if n_win >= 1:
            means = np.stack([
                pkts[i * window:(i + 1) * window, cols].mean(0)
                for i in range(n_win)
            ])
        else:
            means = pkts[:, cols].mean(0, keepdims=True) if len(pkts) \
                else np.zeros((1, len(cols)), np.float32)
        mu = means.mean(0).astype(np.float32)
        sd = (means.std(0) if len(means) > 1
              else np.ones_like(mu)).astype(np.float32)
        return DriftSnapshot(mu, np.maximum(sd, 1e-6), cols)


class DriftDetector:
    """Incremental window-statistics drift monitor.

    Feed every submitted packet window through ``update`` (the
    ``HotSwapController`` does this alongside ``engine.submit``); read
    ``score`` / ``fired``.  ``reset()`` re-arms after a swap so the NEW
    model gets its own drift episode."""

    def __init__(self, snapshot: DriftSnapshot, *, alpha: float = 0.25,
                 threshold: float = 6.0, patience: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.snapshot = snapshot
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.patience = max(1, int(patience))
        self.reset()

    def reset(self) -> None:
        # start AT the reference: score 0 until real windows move it
        self._ewma = self.snapshot.mu.astype(np.float64).copy()
        self.score = 0.0
        self.windows = 0
        self._streak = 0
        self.fired = False

    def update(self, window: np.ndarray) -> float:
        """Fold one packet window into the statistic -> current score."""
        w = np.asarray(window, np.float32)
        if w.ndim == 1:
            w = w[None, :]
        if len(w) == 0:
            return self.score          # empty window: nothing to learn
        m = w[:, self.snapshot.cols].mean(0)
        a = self.alpha
        self._ewma = (1.0 - a) * self._ewma + a * m
        z = np.abs(self._ewma - self.snapshot.mu) / self.snapshot.sd
        self.score = float(z.max())
        self.windows += 1
        self._streak = self._streak + 1 if self.score > self.threshold \
            else 0
        if self._streak >= self.patience:
            self.fired = True
        return self.score

    def report(self) -> dict:
        return {
            "score": round(self.score, 3),
            "threshold": self.threshold,
            "windows": self.windows,
            "fired": self.fired,
        }
