"""Model fusion (paper §3.2.5, Table 4; counterpart of
``repro.core.fusion``).

"Models learning from similar datasets are most likely learning similar
characteristics ... if there are a certain number of features in common,
[Homunculus] will attempt to build a single model to serve both datasets."

``should_fuse`` checks feature overlap (Jaccard over feature names); above
the threshold ``fuse`` trains one *multi-head* DNN: a shared trunk with
one output head per task.  Resources are those of a single trunk + heads
instead of two full models — the paper's Table-4 "about the same as one
split model" effect.

``fuse`` trains on ``device`` (default the card) with the reference's
loss — a per-task masked mean cross-entropy, summed over the tasks — and
its Adam (β 0.9 / 0.999, bias-corrected in f32, ``lr · m̂ / (√v̂ +
1e-8)``), ``max(1, epochs · N // batch)`` steps, He-normal weights and
zero biases.  The initial weights and the minibatch schedule come from
explicit CPU ``torch.Generator``s (``seed`` for the weights, ``seed + 1``
for the schedule, as ``core.mlalgos`` draws them), so a fused model is
not the JAX package's model: its parity is by F1.  On the card the step
is captured once as a CUDA graph and replayed (``mlalgos.run_steps``,
the trainer's own Adam update and replay).

``FusedModel.task_pipeline`` lowers trunk + one head to ``FusedMLP`` +
``Reduce("argmax")``, which serves as one K3 launch per batch on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.mlalgos import (
    TrainedModel,
    adam_buffers,
    adam_update,
    f1_score,
    minibatch_schedule,
    run_steps,
)
from repro_torch.data.netdata import Dataset
from repro_torch.device import resolve_device

FUSE_OVERLAP_THRESHOLD = 0.5


def feature_overlap(a: Dataset, b: Dataset) -> float:
    fa, fb = set(a.feature_names), set(b.feature_names)
    if not fa or not fb:
        return 0.0
    return len(fa & fb) / len(fa | fb)


def _layers_params(layers) -> int:
    return sum(int(l["w"].size + l["b"].size) for l in layers)


@dataclasses.dataclass
class FusedModel:
    """Shared-trunk multi-head DNN over >=2 tasks.  ``params`` is numpy
    ({"trunk": [{"w", "b"}, ...], "heads": [...]}); ``predict`` runs the
    forward on ``device``."""

    trunk_widths: list[int]          # [F, h1, ..., hk]
    heads: list[int]                 # classes per task
    params: dict                     # {"trunk": [...], "heads": [...]}
    datasets: list[Dataset]
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._on_dev = None

    @property
    def param_count(self) -> int:
        return (_layers_params(self.params["trunk"])
                + _layers_params(self.params["heads"]))

    def topology(self, task: int) -> dict:
        """Topology *as mapped on the target* for one task: trunk + head."""
        widths = list(self.trunk_widths) + [self.heads[task]]
        return {"widths": widths, "act": "relu"}

    def fused_topology(self) -> dict:
        """Topology of the single fused pipeline (trunk + concat heads)."""
        widths = list(self.trunk_widths) + [sum(self.heads)]
        return {"widths": widths, "act": "relu"}

    def task_stages(self, task: int):
        """Lower trunk + one head into the stage IR (FusedMLP + argmax):
        the same per-task pipeline the Taurus backend would emit."""
        from repro_torch.core.stageir import FusedMLP, Reduce

        layers = list(self.params["trunk"]) + [self.params["heads"][task]]
        return [FusedMLP([np.asarray(l["w"]) for l in layers],
                         [np.asarray(l["b"]) for l in layers]),
                Reduce("argmax")]

    def task_pipeline(self, task: int, report=None,
                      exec_backend: str = "cuda"):
        """Executable per-task ``codegen.Pipeline`` built from the fused
        stage list on this model's device: one K3 launch per batch on the
        card (``exec_backend="interpret"``: the plain stage walk)."""
        from repro_torch.core.codegen import Pipeline, _spatial_dnn
        from repro_torch.core.feasibility import FeasibilityReport

        topo = self.topology(task)
        report = report or FeasibilityReport(True, [], {}, 0.0, 0.0)
        # per-task count: trunk + this task's head only (NOT all heads) —
        # keeps the stage_summary()["params"] == model.param_count invariant
        n_params = (_layers_params(self.params["trunk"])
                    + _layers_params([self.params["heads"][task]]))
        trained = TrainedModel(
            "dnn", topo, self.params,
            lambda X, _t=task: self.predict(_t, X),
            n_params, self.heads[task], {"fused_task": task},
            scores=lambda X, _t=task: self.logits(_t, X),
        )
        name = f"fused_task{task}"
        return Pipeline(
            name, "taurus", "dnn", self.task_stages(task),
            _spatial_dnn(name, topo["widths"], report.resources),
            report, trained, exec_backend=exec_backend, device=self.device,
        )

    def _device_params(self) -> dict:
        if self._on_dev is None:
            self._on_dev = {
                part: [{k: torch.as_tensor(np.array(l[k], np.float32),
                                           device=self.device)
                        for k in ("w", "b")} for l in layers]
                for part, layers in self.params.items()}
        return self._on_dev

    def logits(self, task: int, X: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        with torch.no_grad():
            out = _fused_forward(self._device_params(), x)[task]
        return out.cpu().numpy()

    def predict(self, task: int, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.logits(task, X), -1).astype(np.int32)

    def f1(self, task: int) -> float:
        d = self.datasets[task]
        return f1_score(
            d.test_y, self.predict(task, d.test_x), num_classes=d.num_classes
        )


def _fused_forward(params, x):
    h = x
    for l in params["trunk"]:
        h = torch.relu(h @ l["w"] + l["b"])
    return [h @ hd["w"] + hd["b"] for hd in params["heads"]]


def _fused_train(params: dict, xs: torch.Tensor, ys: torch.Tensor,
                 masks: torch.Tensor, idx: torch.Tensor, lr: float) -> dict:
    """Adam over the fused model (``fusion.py:125-161``).  ``xs`` [N, F],
    ``ys`` [N, T] int64 labels per task, ``masks`` [N, T] f32 row-task
    validity, ``idx`` [nsteps, batch] the minibatch rows, all on one
    device.  One step reads its rows and bias corrections from two small
    device buffers and updates the weights and moments in place, so on
    the card it is captured once and replayed.  -> the trained params."""
    parts = [(part, i) for part in ("trunk", "heads")
             for i in range(len(params[part]))]
    flat = [params[part][i][k].detach().clone().requires_grad_(True)
            for part, i in parts for k in ("w", "b")]
    p = {"trunk": [], "heads": []}
    for j, (part, i) in enumerate(parts):
        p[part].append({"w": flat[2 * j], "b": flat[2 * j + 1]})
    m, v, bcs, rows, bc = adam_buffers(flat, idx)

    def step():
        yb, mb = ys[rows], masks[rows]
        total = 0.0
        for task, lg in enumerate(_fused_forward(p, xs[rows])):
            logp = torch.log_softmax(lg, -1)
            ce = -torch.gather(logp, 1, yb[:, task:task + 1])[:, 0]
            total = total + torch.sum(ce * mb[:, task]) / torch.clamp(
                torch.sum(mb[:, task]), min=1.0)
        g = list(torch.autograd.grad(total, flat))
        with torch.no_grad():
            adam_update(flat, g, m, v, bc, lr)

    run_steps(step, idx, bcs, rows, bc)
    return {part: [{k: t.detach() for k, t in l.items()} for l in layers]
            for part, layers in p.items()}


def _he(gen: torch.Generator, n_in: int, n_out: int) -> dict:
    return {"w": torch.randn((n_in, n_out), generator=gen)
            * math.sqrt(2.0 / n_in),
            "b": torch.zeros((n_out,))}


def fuse(
    datasets: list[Dataset],
    *,
    hidden: list[int] | None = None,
    epochs: int = 12,
    lr: float = 3e-3,
    batch: int = 256,
    seed: int = 0,
    device="cuda",
) -> FusedModel:
    """Train one shared-trunk model over the (feature-aligned) datasets
    on ``device``."""
    if len(datasets) < 2:
        raise ValueError("fusion needs at least two datasets")
    names = datasets[0].feature_names
    for d in datasets[1:]:
        if d.feature_names != names:
            raise ValueError(
                "fusion requires feature-aligned datasets (align first)")
    dev = resolve_device(device)
    hidden = hidden or [24, 16]
    F = datasets[0].num_features
    T = len(datasets)
    widths = [F] + list(hidden)

    gen = torch.Generator().manual_seed(int(seed))
    trunk = [_he(gen, widths[i], widths[i + 1])
             for i in range(len(widths) - 1)]
    heads = [_he(gen, widths[-1], d.num_classes) for d in datasets]
    params = {part: [{k: t.to(dev) for k, t in l.items()} for l in layers]
              for part, layers in (("trunk", trunk), ("heads", heads))}

    xs = np.concatenate([d.train_x for d in datasets], 0)
    N = len(xs)
    ys = np.zeros((N, T), np.int64)
    masks = np.zeros((N, T), np.float32)
    row = 0
    for t, d in enumerate(datasets):
        n = len(d.train_x)
        ys[row:row + n, t] = d.train_y
        masks[row:row + n, t] = 1.0
        row += n

    nsteps = max(1, epochs * N // batch)
    idx = minibatch_schedule(seed + 1, N, int(nsteps), batch).to(dev)
    trained = _fused_train(
        params, torch.as_tensor(xs, dtype=torch.float32, device=dev),
        torch.as_tensor(ys, device=dev), torch.as_tensor(masks, device=dev),
        idx, float(lr))
    host = {part: [{k: t.cpu().numpy() for k, t in l.items()}
                   for l in layers] for part, layers in trained.items()}
    return FusedModel(widths, [d.num_classes for d in datasets], host,
                      datasets, device=dev)


def should_fuse(a: Dataset, b: Dataset,
                threshold: float = FUSE_OVERLAP_THRESHOLD) -> bool:
    return feature_overlap(a, b) >= threshold
