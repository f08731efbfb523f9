"""Trainable ML algorithms of the compiler (counterpart of
``repro.core.mlalgos``).

The metrics, ``TrainedModel``, KMeans, the linear SVM, the decision tree,
``effective_config`` and ``train``'s dispatch are numpy in the JAX
package and copied here: the same seed gives the same model.  The DNN
trainer (and logistic regression, a DNN with no hidden layer) is PyTorch
on ``device`` (default ``"cuda"``):

  * ``mlp_train`` is the Adam loop of ``mlalgos.py:152-201`` over a
    batch of lanes: the expression order of the JAX loop, masked
    gradients so a zero-padded entry never moves, and the minibatch
    schedule passed in as an ``[nsteps, batch]`` index tensor (the seam
    the parity tests feed the JAX package's schedule through);
  * ``train_dnn`` trains one candidate, ``train_dnn_batch`` one bucket
    of same-depth, same-schedule candidates as ONE batched program
    (``mlalgos.py:204-215``'s vmap written out as a lane dimension).

The initial weights and the schedule come from explicit CPU
``torch.Generator``s seeded as the JAX package seeds its keys (``seed``
for the weights, ``seed + 1`` for the schedule), drawn once and moved to
the device, so a candidate starts from the same numbers on either
device.  The loop issues its steps without a host sync; the trained
weights come back to numpy once per bucket.  ``torch.Generator`` and
``jax.random`` draw different numbers from one seed, so the port's
models are not the JAX package's models: the parity tests hand both the
same initial weights and schedule.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.netdata import Dataset
from repro_torch.device import resolve_device

# ------------------------------------------------------------------ metrics


def f1_score(y_true: np.ndarray, y_pred: np.ndarray, *, num_classes: int = 2,
             average: str = "auto") -> float:
    """Binary F1 (positive class = 1) or macro F1 for multiclass.

    Degenerate inputs score 0.0 (sklearn's zero_division=0 convention):
    empty arrays, an empty positive class, or a class absent from both
    y_true and y_pred all contribute 0 rather than NaN.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0:
        return 0.0
    if average == "auto":
        average = "binary" if num_classes == 2 else "macro"
    classes = [1] if average == "binary" else list(range(num_classes))
    f1s = []
    for c in classes:
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    if y_true.size == 0:
        return 0.0
    return float(np.mean(y_true == np.asarray(y_pred)))


def v_measure(labels: np.ndarray, clusters: np.ndarray) -> float:
    """Homogeneity/completeness harmonic mean (paper Fig. 7 metric)."""
    labels = np.asarray(labels)
    clusters = np.asarray(clusters)
    n = len(labels)
    if n == 0:
        return 0.0
    ls, cs = np.unique(labels), np.unique(clusters)
    cont = np.zeros((len(ls), len(cs)))
    for i, l in enumerate(ls):
        for j, c in enumerate(cs):
            cont[i, j] = np.sum((labels == l) & (clusters == c))
    p = cont / n

    def entropy(marg):
        marg = marg[marg > 0]
        return -np.sum(marg * np.log(marg))

    h_l, h_c = entropy(p.sum(1)), entropy(p.sum(0))
    nz = p > 0
    h_l_given_c = -np.sum(
        p[nz] * (np.log(p[nz]) - np.log(p.sum(0)[None, :].repeat(len(ls), 0)[nz]))
    )
    h_c_given_l = -np.sum(
        p[nz] * (np.log(p[nz]) - np.log(p.sum(1)[:, None].repeat(len(cs), 1)[nz]))
    )
    hom = 1.0 if h_l == 0 else 1.0 - h_l_given_c / h_l
    com = 1.0 if h_c == 0 else 1.0 - h_c_given_l / h_c
    if hom + com == 0:
        return 0.0
    return float(2 * hom * com / (hom + com))


METRICS: dict[str, Callable] = {
    "f1": f1_score,
    "accuracy": lambda yt, yp, **kw: accuracy(yt, yp),
    "v_measure": lambda yt, yp, **kw: v_measure(yt, yp),
}


def evaluate_metric(metric: str, y_true, y_pred, *, num_classes: int) -> float:
    if metric == "f1":
        return f1_score(y_true, y_pred, num_classes=num_classes)
    return METRICS[metric](y_true, y_pred)


# -------------------------------------------------------------- TrainedModel


@dataclasses.dataclass
class TrainedModel:
    algorithm: str            # dnn | kmeans | svm | tree | logreg
    topology: dict            # structure for the backend codegen
    params: Any               # learned parameters (numpy)
    predict: Callable         # X [N,F] -> y [N]
    param_count: int
    num_classes: int
    config: dict              # the DSE configuration that produced it
    # X [N, F] -> the class scores predict takes its arg-reduce over
    # (logits; squared centroid distances for kmeans), None for a tree:
    # what ``codegen.Pipeline.verify``'s margin rule reads
    scores: Callable | None = None
    # a DNN/logreg model's bucket, shared by its lanes: {"lanes",
    # "nsteps", "batch", "widths", "s"} (host seconds from the bucket's
    # start to its trained weights on the host); None for the others
    bucket: dict | None = None


# ------------------------------------------------------------------- DNN


def _mlp_init(gen: torch.Generator, widths: list[int]) -> list[dict]:
    """He-normal weights, zero biases, drawn on the CPU from ``gen``."""
    params = []
    for i in range(len(widths) - 1):
        fan_in = widths[i]
        params.append({
            "w": torch.randn((widths[i], widths[i + 1]), generator=gen)
            * math.sqrt(2.0 / fan_in),
            "b": torch.zeros((widths[i + 1],)),
        })
    return params


def mlp_forward(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP returning logits — the math the generated Taurus pipeline
    executes (kernels/fused_mlp K3/K5).  A leading lane dimension on the
    weights ([L, d_in, d_out]) runs L models over one input."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + (layer["b"] if layer["b"].dim() == 1
                              else layer["b"][:, None, :])
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def minibatch_schedule(seed: int, n: int, nsteps: int, batch: int
                       ) -> torch.Tensor:
    """The [nsteps, batch] row indices of every step, drawn at once from
    a CPU generator seeded ``seed`` (the JAX package's ``seed + 1`` key)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, n, (nsteps, batch), generator=gen)


def mlp_train(params: list[dict], masks: list[dict] | None,
              x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
              lrs: torch.Tensor, *, l2: float = 1e-4) -> list[dict]:
    """Adam over stacked lanes (``mlalgos.py:152-201``, batched).

    ``params``: per layer {"w" [L, d_in, d_out], "b" [L, d_out]};
    ``masks`` the same shapes (0/1; None: all ones); ``x`` [n, F] f32,
    ``y`` [n] int64 and ``idx`` [nsteps, batch] int64, all on one device;
    ``lrs`` [L] f32.  Every lane shares the schedule.  The loss is summed
    over lanes, so each lane's gradient is its own model's.  Expression
    order as the JAX loop: CE = -mean(take(log_softmax)) + l2 * sum(w^2)
    over the weights, m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g g, the
    bias corrections in f32, p - lr * mh / (sqrt(vh) + 1e-8).

    One step reads its minibatch rows and bias corrections from two
    small device buffers and updates the weights and moments in place,
    so on the card it is captured once as a CUDA graph (``_Replayed``)
    and replayed for every later step: no host sync and one graph launch
    per step.  -> the trained params (new tensors)."""
    n_layers = len(params)
    flat = [layer[k].detach().clone().requires_grad_(True)
            for layer in params for k in ("w", "b")]
    mflat = None if masks is None else \
        [layer[k] for layer in masks for k in ("w", "b")]
    # each tensor's lane learning rates, expanded to its shape once so the
    # update runs as whole-list (foreach) launches
    lr = [lrs.reshape((-1,) + (1,) * (q.dim() - 1)).expand_as(q).contiguous()
          for q in flat]
    m, v, bcs, rows, bc = adam_buffers(flat, idx)
    p = [{"w": flat[2 * k], "b": flat[2 * k + 1]} for k in range(n_layers)]

    def step():
        logits = mlp_forward(p, x[rows])                  # [L, batch, C]
        logp = torch.log_softmax(logits, -1)
        take = torch.gather(
            logp, 2, y[rows].reshape(1, -1, 1).expand(logp.shape[0], -1, 1))
        ce = -torch.mean(take[..., 0], 1)                 # [L]
        reg = sum(torch.sum(torch.square(layer["w"]), (1, 2)) for layer in p)
        g = list(torch.autograd.grad(torch.sum(ce + l2 * reg), flat))
        with torch.no_grad():
            if mflat is not None:
                g = torch._foreach_mul(g, mflat)
            adam_update(flat, g, m, v, bc, lr)

    run_steps(step, idx, bcs, rows, bc)
    return [{"w": flat[2 * k].detach(), "b": flat[2 * k + 1].detach()}
            for k in range(n_layers)]


def adam_buffers(flat: list, idx: torch.Tensor) -> tuple:
    """Adam's state for the tensors ``flat`` over the schedule ``idx``
    ([nsteps, batch]) -> (m, v, bcs, rows, bc): zero moments, every
    step's bias corrections 1 - beta**t ([nsteps, 2], in f32 as the JAX
    loops compute them) and the two buffers one step reads its minibatch
    rows and its corrections from, on ``idx``'s device."""
    m = [torch.zeros_like(q) for q in flat]
    v = [torch.zeros_like(q) for q in flat]
    t = np.arange(1, idx.shape[0] + 1, dtype=np.float32)
    bcs = torch.from_numpy(np.stack(
        [np.float32(1) - np.float32(0.9) ** t,
         np.float32(1) - np.float32(0.999) ** t], 1)).to(idx.device)
    return m, v, bcs, torch.empty_like(idx[0]), torch.empty_like(bcs[0])


def adam_update(flat: list, g: list, m: list, v: list, bc: torch.Tensor,
                lr) -> None:
    """One Adam update in place, in the JAX loops' expression order:
    m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g g, p -= lr * (m / bc[0]) /
    (sqrt(v / bc[1]) + 1e-8).  ``lr``: a float or one tensor per entry
    of ``flat``."""
    torch._foreach_mul_(m, 0.9)
    torch._foreach_add_(m, torch._foreach_mul(g, 0.1))
    torch._foreach_mul_(v, 0.999)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 0.001),
                                              g))
    mh = torch._foreach_div(m, bc[0])
    vh = torch._foreach_div(v, bc[1])
    torch._foreach_sub_(flat, torch._foreach_div(
        torch._foreach_mul(mh, lr),
        torch._foreach_add(torch._foreach_sqrt(vh), 1e-8)))


def run_steps(step, idx: torch.Tensor, bcs: torch.Tensor,
              rows: torch.Tensor, bc: torch.Tensor) -> None:
    """Run ``step`` once per row of ``idx``, its minibatch rows and bias
    corrections copied into ``rows`` and ``bc`` first: eagerly on the
    CPU, replayed as one CUDA graph on the card (``_Replayed``)."""
    run = _Replayed(step) if rows.device.type == "cuda" else step
    for i in range(idx.shape[0]):
        rows.copy_(idx[i])
        bc.copy_(bcs[i])
        run()


class _Replayed:
    """``fn`` (no arguments, all state in device tensors it updates in
    place) run eagerly for its first ``WARMUP`` calls on a side stream, as
    CUDA graph capture requires, then captured once; that call and every
    later one replay the graph: the same kernels in the same order, so
    the same bits as the eager calls.

    The capture is ``capture_error_mode="thread_local"``: a retrain
    worker (``serve.online``) captures while the serving thread waits on
    events and allocates, which the default "global" mode would make
    illegal calls that fail the capture."""

    WARMUP = 3

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0
        self.graph = None

    def __call__(self):
        if self.graph is None and self.calls < self.WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream().wait_stream(side)
        else:
            if self.graph is None:
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self.fn()
            self.graph.replay()
        self.calls += 1


def dnn_model(params: list[dict], widths: list[int], num_classes: int,
              config: dict, *, algorithm: str = "dnn",
              device="cuda") -> TrainedModel:
    """Package numpy MLP params as a TrainedModel whose ``predict`` and
    ``scores`` run ``mlp_forward`` on ``device`` (shared by the trainers
    and ``convert.trained_from_reference``)."""
    dev = resolve_device(device)
    params = [{"w": np.array(l["w"], np.float32),
               "b": np.array(l["b"], np.float32)} for l in params]
    on_dev = [{k: torch.as_tensor(a, device=dev) for k, a in l.items()}
              for l in params]

    def scores(X):
        x = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        with torch.no_grad():
            return mlp_forward(on_dev, x).cpu().numpy()

    def predict(X):
        return np.argmax(scores(X), -1).astype(np.int32)

    n_params = sum(int(l["w"].size + l["b"].size) for l in params)
    return TrainedModel(
        algorithm, {"widths": list(widths), "act": "relu"},
        params, predict, n_params, num_classes, config, scores,
    )


def train_dnn(
    data: Dataset,
    *,
    hidden: list[int],
    lr: float = 3e-3,
    batch: int = 256,
    epochs: int = 12,
    seed: int = 0,
    config: dict | None = None,
    device="cuda",
) -> TrainedModel:
    """One candidate: a bucket of one lane."""
    F, C = data.num_features, data.num_classes
    widths = [F] + list(hidden) + [C]
    nsteps = max(1, epochs * len(data.train_x) // batch)
    return _train_bucket(data, [(widths, float(lr))], batch, int(nsteps),
                         seed=seed, configs=[config or {"hidden": hidden}],
                         algorithm="dnn", device=device)[0]


# ------------------------------------------- population-parallel DNN training
#
# The DSE engine (core.dse) proposes a *batch* of configurations per BO
# round.  DNN/logreg candidates are bucketed by (layer count, minibatch
# size, step count); within a bucket every layer is zero-padded to the
# bucket-max width, gradients are masked to the real entries, and ONE
# batched program trains the whole bucket.  Each candidate starts from
# the same generator stream as train_dnn, so a bucket lane reproduces the
# sequential trainer's result for that config up to summation order.

def _dnn_hidden(config: dict) -> list[int]:
    """Hidden widths a DSE config denotes (mirrors train()'s dnn branch)."""
    return [config[f"h{i}"] for i in range(int(config.get("n_layers", 0)))
            if config.get(f"h{i}", 0) > 0]


def _dnn_job(data: Dataset, config: dict, algorithm: str
             ) -> tuple[list[int], float, int, int]:
    """(widths, lr, batch, nsteps) exactly as the sequential path computes
    them — the bucket key and the cache key both hang off these."""
    F, C = data.num_features, data.num_classes
    if algorithm == "logreg":
        widths = [F, C]
        lr, batch, epochs = float(config.get("lr", 0.1)), 256, 30
    else:
        widths = [F] + _dnn_hidden(config) + [C]
        lr = float(config.get("lr", 3e-3))
        batch = int(config.get("batch", 256))
        epochs = int(config.get("epochs", 12))
    nsteps = max(1, epochs * len(data.train_x) // batch)
    return widths, lr, batch, int(nsteps)


def _pad_mlp_params(params: list[dict], widths: list[int],
                    padded: list[int]) -> tuple[list[dict], list[dict]]:
    """Zero-pad per-layer params into the bucket shape + matching 0/1 masks."""
    pp, mm = [], []
    for i in range(len(padded) - 1):
        w = torch.zeros((padded[i], padded[i + 1]))
        b = torch.zeros((padded[i + 1],))
        mw, mb = torch.zeros_like(w), torch.zeros_like(b)
        w[: widths[i], : widths[i + 1]] = params[i]["w"]
        b[: widths[i + 1]] = params[i]["b"]
        mw[: widths[i], : widths[i + 1]] = 1.0
        mb[: widths[i + 1]] = 1.0
        pp.append({"w": w, "b": b})
        mm.append({"w": mw, "b": mb})
    return pp, mm


def _train_bucket(data: Dataset, jobs: list[tuple[list[int], float]],
                  batch: int, nsteps: int, *, seed: int, configs: list[dict],
                  algorithm: str, device) -> list[TrainedModel]:
    """Train one bucket (same depth, batch and step count) as one batched
    program; ``jobs`` = [(widths, lr)] -> one TrainedModel per job."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(data.train_x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(data.train_y, np.int64), device=dev)
    padded = [max(j[0][i] for j in jobs) for i in range(len(jobs[0][0]))]
    inits, masks = [], []
    for widths, _ in jobs:
        p = _mlp_init(torch.Generator().manual_seed(int(seed)), widths)
        pp, mm = _pad_mlp_params(p, widths, padded)
        inits.append(pp)
        masks.append(mm)

    def stack(trees):
        return [{k: torch.stack([t[i][k] for t in trees]).to(dev)
                 for k in ("w", "b")} for i in range(len(padded) - 1)]

    lrs = torch.tensor([lr for _, lr in jobs], dtype=torch.float32,
                       device=dev)
    idx = minibatch_schedule(seed + 1, len(data.train_x), nsteps,
                             batch).to(dev)
    trained = mlp_train(stack(inits), stack(masks), x, y, idx, lrs)
    host = [{k: t.cpu().numpy() for k, t in layer.items()}
            for layer in trained]
    bucket = {"lanes": len(jobs), "nsteps": nsteps, "batch": batch,
              "widths": padded, "s": time.perf_counter() - t0}
    out = []
    for lane, (widths, _) in enumerate(jobs):
        p = [{"w": layer["w"][lane][: widths[i], : widths[i + 1]].copy(),
              "b": layer["b"][lane][: widths[i + 1]].copy()}
             for i, layer in enumerate(host)]
        tm = dnn_model(p, widths, data.num_classes, dict(configs[lane]),
                       algorithm=algorithm, device=dev)
        tm.bucket = bucket
        out.append(tm)
    return out


def train_dnn_batch(data: Dataset, configs: list[dict], *, seed: int = 0,
                    algorithm: str = "dnn", device="cuda"
                    ) -> list[TrainedModel]:
    """Train many DNN/logreg candidates with one batched run per bucket."""
    out: list[TrainedModel | None] = [None] * len(configs)
    buckets: dict[tuple, list[tuple]] = {}
    for ci, cfg in enumerate(configs):
        widths, lr, batch, nsteps = _dnn_job(data, cfg, algorithm)
        buckets.setdefault((len(widths), batch, nsteps), []).append(
            (ci, widths, lr))
    for (_, batch, nsteps), js in buckets.items():
        models = _train_bucket(
            data, [(w, lr) for _, w, lr in js], batch, nsteps, seed=seed,
            configs=[configs[ci] for ci, _, _ in js], algorithm=algorithm,
            device=device)
        for (ci, _, _), tm in zip(js, models):
            out[ci] = tm
    return out


def train_batch(algorithm: str, data: Dataset, configs: list[dict], *,
                seed: int = 0, workers: int | None = None, device="cuda"
                ) -> list[TrainedModel]:
    """Population-parallel ``train``: batched buckets for dnn/logreg on
    ``device``, a thread pool fanning out the numpy algorithms."""
    if not configs:
        return []
    if algorithm in ("dnn", "logreg"):
        return train_dnn_batch(data, configs, seed=seed, algorithm=algorithm,
                               device=device)
    if len(configs) == 1:
        return [train(algorithm, data, configs[0], seed=seed, device=device)]
    import concurrent.futures
    import os

    workers = workers or min(8, os.cpu_count() or 1, len(configs))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(
            lambda cfg: train(algorithm, data, cfg, seed=seed,
                              device=device), configs
        ))


def effective_config(algorithm: str, config: dict, data: Dataset) -> dict:
    """The subset of a DSE config that actually reaches ``train`` — the
    content half of the trained-candidate cache key.  Two configs with the
    same effective form train to the same model (e.g. dnn h_i beyond
    n_layers are dead parameters)."""
    if algorithm == "dnn":
        widths, lr, batch, nsteps = _dnn_job(data, config, algorithm)
        return {"widths": widths, "lr": lr, "batch": batch, "nsteps": nsteps}
    if algorithm == "logreg":
        return {"lr": float(config.get("lr", 0.1))}
    if algorithm == "kmeans":
        n_feat = int(config.get("n_features", data.num_features))
        return {"k": int(config["k"]),
                "n_features": min(n_feat, data.num_features)}
    if algorithm == "svm":
        return {"c_reg": float(config.get("c_reg", 1.0))}
    if algorithm == "tree":
        return {"max_depth": int(config.get("max_depth", 6))}
    raise KeyError(algorithm)


# ----------------------------------------------------------------- KMeans


def kmeans_model(cent: np.ndarray, label_map: np.ndarray,
                 feature_idx: list[int] | None, num_classes: int,
                 config: dict, *, n_inputs: int | None = None
                 ) -> TrainedModel:
    """KMeans parameters -> TrainedModel (numpy predict/assign).
    ``n_inputs``: the input rows' width (default: the centroids'), which
    the topology carries beside the JAX package's keys so the MAT
    accounting can charge every input feature's table."""

    def distances(X_):
        X_ = X_ if feature_idx is None else X_[:, feature_idx]
        return ((X_[:, None, :] - cent[None]) ** 2).sum(-1)

    def assign(X_):
        return distances(X_).argmin(1)

    def predict(X_):
        return label_map[assign(X_)]

    k = cent.shape[0]
    tm = TrainedModel(
        "kmeans",
        {"k": k, "n_features": cent.shape[1], "feature_idx": feature_idx,
         "n_inputs": int(n_inputs or cent.shape[1])},
        {"centroids": cent, "label_map": label_map},
        predict, int(cent.size), num_classes, config, distances,
    )
    tm.topology["assign"] = assign  # raw cluster ids for v_measure
    return tm


def train_kmeans(
    data: Dataset, *, k: int, iters: int = 50, seed: int = 0,
    feature_idx: list[int] | None = None, config: dict | None = None,
) -> TrainedModel:
    rng = np.random.default_rng(seed)
    X = data.train_x if feature_idx is None else data.train_x[:, feature_idx]
    init = X[rng.choice(len(X), size=k, replace=False)]
    cent = init.copy()
    for _ in range(iters):
        d = ((X[:, None, :] - cent[None]) ** 2).sum(-1)
        a = d.argmin(1)
        for j in range(k):
            pts = X[a == j]
            if len(pts):
                cent[j] = pts.mean(0)
    # majority-label map cluster -> class (for classification use)
    d = ((X[:, None, :] - cent[None]) ** 2).sum(-1)
    a = d.argmin(1)
    label_map = np.zeros(k, np.int32)
    for j in range(k):
        ys = data.train_y[a == j]
        label_map[j] = np.bincount(ys, minlength=data.num_classes).argmax() \
            if len(ys) else 0
    return kmeans_model(cent, label_map, feature_idx, data.num_classes,
                        config or {"k": k}, n_inputs=data.num_features)


# -------------------------------------------------------------- linear SVM


def svm_model(W: np.ndarray, b: np.ndarray, config: dict) -> TrainedModel:
    """Linear SVM parameters -> TrainedModel (numpy predict)."""
    F, C = W.shape

    def scores(X_):
        return X_ @ W + b

    def predict(X_):
        return np.argmax(scores(X_), 1).astype(np.int32)

    return TrainedModel(
        "svm", {"n_features": F, "n_classes": C},
        {"W": W, "b": b}, predict, int(W.size + b.size), C, config, scores,
    )


def train_svm(
    data: Dataset, *, c_reg: float = 1.0, epochs: int = 20, lr: float = 1e-2,
    seed: int = 0, config: dict | None = None,
) -> TrainedModel:
    """One-vs-rest linear SVM via hinge-loss SGD (numpy)."""
    rng = np.random.default_rng(seed)
    X, y = data.train_x, data.train_y
    N, F = X.shape
    C = data.num_classes
    W = np.zeros((F, C), np.float32)
    b = np.zeros(C, np.float32)
    Y = np.where(y[:, None] == np.arange(C)[None], 1.0, -1.0).astype(np.float32)
    for ep in range(epochs):
        perm = rng.permutation(N)
        for start in range(0, N, 512):
            idx = perm[start:start + 512]
            s = X[idx] @ W + b  # [b, C]
            margin = Y[idx] * s
            active = (margin < 1.0).astype(np.float32)
            gW = -(X[idx].T @ (active * Y[idx])) / len(idx) + W / (c_reg * N)
            gb = -(active * Y[idx]).mean(0)
            W -= lr * gW
            b -= lr * gb
    return svm_model(W, b, config or {"c_reg": c_reg})


# ---------------------------------------------------------- decision tree


def tree_model(nodes: list[dict], depth: int, num_classes: int,
               config: dict) -> TrainedModel:
    """Flat CART nodes -> TrainedModel (numpy walk)."""

    def predict(X_):
        out = np.zeros(len(X_), np.int32)
        for i, row in enumerate(X_):
            nid = 0
            while "leaf" not in nodes[nid]:
                nd = nodes[nid]
                nid = nd["left"] if row[nd["feat"]] <= nd["thr"] else nd["right"]
            out[i] = nodes[nid]["leaf"]
        return out

    return TrainedModel(
        "tree", {"nodes": nodes, "depth": depth},
        {"nodes": nodes}, predict, len(nodes), num_classes, config,
    )


def train_tree(
    data: Dataset, *, max_depth: int = 6, min_leaf: int = 16, seed: int = 0,
    config: dict | None = None,
) -> TrainedModel:
    """CART (gini) classifier; nodes stored flat for MAT codegen."""
    X, y = data.train_x, data.train_y
    C = data.num_classes
    nodes: list[dict] = []  # {feat, thr, left, right, leaf_class}

    def gini(ys):
        if len(ys) == 0:
            return 0.0
        p = np.bincount(ys, minlength=C) / len(ys)
        return 1.0 - np.sum(p * p)

    def build(idx, depth) -> int:
        ys = y[idx]
        node_id = len(nodes)
        nodes.append({})
        if depth >= max_depth or len(idx) < 2 * min_leaf or gini(ys) < 1e-6:
            nodes[node_id] = {"leaf": int(np.bincount(ys, minlength=C).argmax())}
            return node_id
        best = (None, None, np.inf)
        for f in range(X.shape[1]):
            vals = X[idx, f]
            qs = np.quantile(vals, np.linspace(0.1, 0.9, 9))
            for thr in qs:
                l = idx[vals <= thr]
                r = idx[vals > thr]
                if len(l) < min_leaf or len(r) < min_leaf:
                    continue
                score = (len(l) * gini(y[l]) + len(r) * gini(y[r])) / len(idx)
                if score < best[2]:
                    best = (f, thr, score)
        if best[0] is None:
            nodes[node_id] = {"leaf": int(np.bincount(ys, minlength=C).argmax())}
            return node_id
        f, thr, _ = best
        # thresholds live at f32 so the numpy walk and the TreeTraverse
        # stage (f32 compare) make identical split decisions
        thr = float(np.float32(thr))
        l_id = build(idx[X[idx, f] <= thr], depth + 1)
        r_id = build(idx[X[idx, f] > thr], depth + 1)
        nodes[node_id] = {"feat": int(f), "thr": thr,
                          "left": l_id, "right": r_id}
        return node_id

    build(np.arange(len(X)), 0)
    return tree_model(nodes, max_depth, C, config or {"max_depth": max_depth})


# ------------------------------------------------------- logistic regression


def train_logreg(
    data: Dataset, *, lr: float = 0.1, epochs: int = 30, seed: int = 0,
    config: dict | None = None, device="cuda",
) -> TrainedModel:
    tm = train_dnn(data, hidden=[], lr=lr, epochs=epochs, seed=seed,
                   config=config or {}, device=device)
    tm.algorithm = "logreg"
    return tm


# ------------------------------------------------------------------ train()

SUPPORTED_ALGORITHMS = ["dnn", "kmeans", "svm", "tree", "logreg"]


def train(algorithm: str, data: Dataset, config: dict, *, seed: int = 0,
          device="cuda") -> TrainedModel:
    """Uniform entry point the DSE loop calls with a BO-suggested config;
    ``device`` is where the DNN/logreg trainer runs (the numpy algorithms
    ignore it)."""
    if algorithm == "dnn":
        hidden = _dnn_hidden(config)
        return train_dnn(
            data, hidden=hidden, lr=config.get("lr", 3e-3),
            batch=config.get("batch", 256), epochs=config.get("epochs", 12),
            seed=seed, config=config, device=device,
        )
    if algorithm == "kmeans":
        n_feat = config.get("n_features", data.num_features)
        fi = list(range(n_feat)) if n_feat < data.num_features else None
        return train_kmeans(data, k=config["k"], seed=seed, feature_idx=fi,
                            config=config)
    if algorithm == "svm":
        return train_svm(data, c_reg=config.get("c_reg", 1.0), seed=seed,
                         config=config)
    if algorithm == "tree":
        return train_tree(data, max_depth=config.get("max_depth", 6),
                          seed=seed, config=config)
    if algorithm == "logreg":
        return train_logreg(data, lr=config.get("lr", 0.1), seed=seed,
                            config=config, device=device)
    raise KeyError(algorithm)
