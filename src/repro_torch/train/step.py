"""Training step (counterpart of ``repro.train.step``): microbatched
gradient accumulation, clipping, the schedule and the optimizer update.

``init_train_state`` makes the state tree ``{"params", "opt", "step"}``
on a device: master weights in ``cfg.master_dtype`` (f32, or bf16 for
the 398B-scale config), the optimizer's moments in f32, ``step`` an
int32 0-dim tensor.  ``make_train_step`` returns ``train_step(state,
batch) -> (state, metrics)``; it runs the forward on the bf16 compute
copy (``cast_for_compute``: the reference's dtype for every leaf) in
``mode="train"``, takes the gradients against the master weights with
autograd (K7b and K8b under ``backend="cuda"`` on CUDA tensors), and
updates ``state`` IN PLACE: the
reference donates its state to the jitted step, and at Qwen3-1.7B's
width a second copy of weights and moments would be 20 GB.  The state
returned is the one passed in.

``experts`` (all three entry points): the contiguous share of expert ids
the MoE layers hold, as ``registry.init_params(experts=)`` and serving
take it; None holds all.  It is the one-card stand-in for the
reference's ``"ep"`` sharding of the expert weights: a card trains the
share it holds, and routing still runs over every expert.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.pytree import (
    ParamDef,
    cast_floating,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_paths,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import (
    decoder_layout,
    encoder_layout,
    forward,
)
from repro_torch.optim import clip_by_global_norm, get_optimizer, warmup_cosine
from repro_torch.train.losses import total_loss

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1
    max_grad_norm: float = 1.0
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    remat: bool = True


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def stack_groups(cfg: ModelConfig):
    """path -> the reference's scan-stacked leaf it belongs to: layer l of
    a stack is slot l % P of its period, stacked over the periods."""
    periods = {"layers": len(decoder_layout(cfg)[1]),
               "encoder": len(encoder_layout(cfg)[1])}

    def group_of(path):
        if path and path[0] in periods:
            return (path[0], path[1] % periods[path[0]]) + tuple(path[2:])
        return tuple(path)

    return group_of


def _optimizer(cfg: ModelConfig):
    return get_optimizer(cfg.optimizer, group_of=stack_groups(cfg))


def train_state_defs(cfg: ModelConfig, experts=None) -> dict:
    """The state tree as ParamDefs (master weights in
    ``cfg.master_dtype`` on the parameters' axes), nothing allocated."""
    master = _dtype(cfg.master_dtype)
    pdefs = tree_map(lambda d: dataclasses.replace(d, dtype=master),
                     registry.layer_defs(cfg, experts))
    return {"params": pdefs, "opt": _optimizer(cfg).state_defs(pdefs),
            "step": ParamDef((), torch.int32, (), "zeros")}


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device="cuda", experts=None) -> dict:
    """Seeded master weights (``registry.init_params``' draws) in
    ``cfg.master_dtype``, MoE layers holding ``experts``, zero moments,
    step 0, all on ``device`` (``generator`` must live there)."""
    dev = resolve_device(device)
    master = _dtype(cfg.master_dtype)
    params = cast_floating(registry.init_params(
        cfg, generator=generator, device=dev, dtype=master,
        experts=experts), master)
    return {"params": params, "opt": _optimizer(cfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# the per-layer stacks: the reference holds each as one leaf stacked over
# the periods, one rank above the port's per-layer leaf
STACKED = ("layers", "encoder")


def cast_for_compute(params):
    """Master -> bf16 compute copy, leaf for leaf in the dtype the
    reference's ``cast_for_compute`` gives it: that one casts every leaf of
    rank >= 2 of the scan-stacked tree, so a per-layer leaf (under
    ``STACKED``) becomes bf16 at rank >= 1 (norm scales, biases, the Mamba
    mixer's ``D``, ``dt_bias``, ``conv_b`` and ``norm``) and any other
    leaf at rank >= 2; per-layer scalars and the embedding's and final
    norm's 1-D leaves stay as they are."""
    def leaf(path, x):
        rank = x.dim() + (1 if path and path[0] in STACKED else 0)
        if x.is_floating_point() and rank >= 2:
            return x.to(torch.bfloat16)
        return x

    return tree_map_with_path(leaf, params)


def make_grad_fn(cfg: ModelConfig, settings: TrainSettings = TrainSettings(),
                 *, backend: str = "cuda", experts=None):
    """-> ``grad_fn(params, batch) -> (metrics, grads)``: the loss of
    ``forward`` on the bf16 compute copy (``cast_for_compute``) and its
    gradients against the master weights, a tree like ``params``; nothing
    is updated.  ``backend``: "cuda" (K7 and K7b, K8 and K8b on CUDA
    tensors) or "interpret" (the plain attention and scan and autograd's
    gradients of them).  ``experts``: the share the MoE layers hold."""
    def loss_fn(params, mb):
        kwargs = {}
        if cfg.family == "encdec":
            kwargs["memory_embeds"] = mb["frames"]
        if cfg.family == "vlm":
            kwargs["memory_embeds"] = mb["image_embeds"]
        logits, _, aux = forward(
            cast_for_compute(params), cfg, tokens=mb["tokens"], mode="train",
            remat=settings.remat, backend=backend, experts=experts,
            **kwargs)
        return total_loss(logits, mb["targets"], aux)

    def grad_fn(params, mb):
        tree = tree_map(lambda x: x.detach().requires_grad_(), params)
        paths, leaves = tree_paths(tree), tree_leaves(tree)
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_path = {p: torch.zeros_like(x) if g is None else g
                   for p, x, g in zip(paths, leaves, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_map_with_path(lambda p, _: by_path[p], params)

    return grad_fn


def make_train_step(cfg: ModelConfig,
                    settings: TrainSettings = TrainSettings(), *,
                    backend: str = "cuda", experts=None):
    """-> ``train_step(state, batch) -> (state, metrics)``.  ``batch``:
    tensors on the state's device, ``tokens`` and ``targets`` [B, S]
    (an encdec's ``frames``, a vlm's ``image_embeds`` [B, M, d] go in as
    ``memory_embeds``).  Microbatches are a loop over equal slices of B
    whose f32 gradients are summed and divided by their number (the
    reference's ``scan``, without its mesh constraint); metrics are then
    their means.  ``backend`` and ``experts`` as ``make_grad_fn``'s."""
    opt = _optimizer(cfg)
    grad_fn = make_grad_fn(cfg, settings, backend=backend, experts=experts)

    def train_step(state, batch):
        params = state["params"]
        n = settings.microbatches
        if n == 1:
            metrics, grads = grad_fn(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n:
                raise ValueError(f"batch {B} is not {n} equal microbatches")
            grads, ms = None, []
            for i in range(n):
                mb = {k: v[i * (B // n):(i + 1) * (B // n)]
                      for k, v in batch.items()}
                m, g = grad_fn(params, mb)
                ms.append(m)
                g = tree_map(lambda x: x.to(F32), g)
                grads = g if grads is None else tree_map(
                    lambda a, b: a.add_(b), grads, g)
            grads = tree_map(lambda g: g.div_(n), grads)
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, settings.max_grad_norm)
        lr = warmup_cosine(state["step"], peak_lr=settings.peak_lr,
                           warmup=settings.warmup, total=settings.total_steps)
        opt.update(grads, state["opt"], params, lr, state["step"])
        del grads
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        state["step"].add_(1)
        return state, metrics

    return train_step

