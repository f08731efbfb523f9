"""Optimizers (counterpart of ``repro.optim.optimizers``): AdamW and
Adafactor, written out per tensor with the reference's expression order.

``update(grads, state, params, lr, step)`` updates ``state`` and
``params`` in place and returns them (the reference returns new trees and
donates the old ones; at Qwen3-1.7B's width a second copy of the master
weights and moments would be 20 GB).  ``lr`` and ``step`` are 0-dim
tensors (``step`` an int).  ``state_defs(param_defs)`` takes a tree of
(shape, dtype) pairs and gives the state's, for the ``launch/`` slice's
dry-run.

Adafactor's update clip and relative step take the RMS of a whole
leaf.  The reference's leaves are scan-stacked over a stack's periods, so
its RMS runs over every layer of a slot; ``group_of(path)`` (None: each
leaf alone) names the leaves that share those statistics, and
``train.step`` passes the stacking of the port's per-layer tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.pytree import tree_leaves, tree_map, tree_paths

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable        # params -> opt_state
    update: Callable      # (grads, state, params, lr, step) -> (params, state)
    state_defs: Callable  # param (shape, dtype) tree -> opt_state's


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of sum(g^2), f32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled in place by min(1, max_norm / max(norm, 1e-9)),
    norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_shape(d) -> bool:
    return isinstance(d, tuple) and len(d) == 2 and isinstance(d[0], tuple)


# ----------------------------------------------------------------- AdamW


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        def zero(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)

        return {"m": tree_map(zero, params), "v": tree_map(zero, params)}

    def state_defs(defs):
        f32 = lambda d: (tuple(d[0]), F32)  # noqa: E731
        return {"m": _map_defs(f32, defs), "v": _map_defs(f32, defs)}

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        t = step.to(F32) + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for path in tree_paths(params):
            g = _get(grads, path).to(F32)
            m, v, p = (_get(state["m"], path), _get(state["v"], path),
                       _get(params, path))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1
            vh = v / bc2
            upd = mh / (torch.sqrt(vh) + eps)
            p32 = p.to(F32)
            upd = upd + weight_decay * p32
            p.copy_((p32 - lr * upd).to(p.dtype))
        return params, state

    return Optimizer("adamw", init, update, state_defs)


# -------------------------------------------------------------- Adafactor


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(eps=1e-30, clip_threshold=1.0, decay_pow=0.8, min_scale=1e-3,
              group_of: Callable | None = None) -> Optimizer:
    def zeros(shape, device):
        return torch.zeros(shape, dtype=F32, device=device)

    def init(params):
        def leaf(p):
            s = tuple(p.shape)
            if _factored(s):
                return {"vr": zeros(s[:-1], p.device),
                        "vc": zeros(s[:-2] + s[-1:], p.device)}
            return {"v": zeros(s, p.device)}

        return {"f": tree_map(leaf, params)}

    def state_defs(defs):
        def leaf(d):
            s = tuple(d[0])
            if _factored(s):
                return {"vr": (s[:-1], F32), "vc": (s[:-2] + s[-1:], F32)}
            return {"v": (s, F32)}

        return {"f": _map_defs(leaf, defs)}

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        # one group at a time: its leaves' second moments and f32 updates,
        # the group's sums of squares, then its leaves updated, so that
        # only the largest group's updates are held at once (every leaf's
        # at once would be twice the bf16 weights)
        t = step.to(F32) + 1.0
        beta2 = 1.0 - t ** (-decay_pow)
        groups = {}
        for path in tree_paths(params):
            key = path if group_of is None else group_of(path)
            groups.setdefault(key, []).append(path)
        for members in groups.values():
            upds, n, su, sp = [], 0, 0.0, 0.0
            for path in members:
                g = _get(grads, path).to(F32)
                s = _get(state["f"], path)
                g2 = torch.square(g) + eps
                if _factored(g.shape):
                    s["vr"].copy_(beta2 * s["vr"]
                                  + (1 - beta2) * torch.mean(g2, dim=-1))
                    s["vc"].copy_(beta2 * s["vc"]
                                  + (1 - beta2) * torch.mean(g2, dim=-2))
                    denom = torch.clamp_min(
                        torch.mean(s["vr"], dim=-1, keepdim=True), eps)
                    vhat = s["vr"][..., None] * s["vc"][..., None, :] \
                        / denom[..., None]
                else:
                    s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)
                    vhat = s["v"]
                del g2
                upd = g * torch.rsqrt(vhat + eps)
                p32 = _get(params, path).to(F32)
                n += upd.numel()
                su = su + torch.sum(torch.square(upd))
                sp = sp + torch.sum(torch.square(p32))
                upds.append(upd)
            # update clipping by RMS; the relative step size
            rms_u = torch.sqrt(su / n + eps)
            scale = torch.clamp_min(torch.sqrt(sp / n), min_scale)
            for path, upd in zip(members, upds):
                upd = upd / torch.clamp_min(rms_u / clip_threshold, 1.0)
                p = _get(params, path)
                p32 = p.to(F32)
                p.copy_((p32 - lr * scale * upd).to(p.dtype))
        return params, state

    return Optimizer("adafactor", init, update, state_defs)


def _map_defs(fn, defs):
    if _is_shape(defs):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v) for k, v in defs.items()}
    return [_map_defs(fn, v) for v in defs]


def get_optimizer(name: str, group_of: Callable | None = None) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor(group_of=group_of)
    raise ValueError(name)


def opt_state_defs(name: str, param_defs) -> Any:
    return get_optimizer(name).state_defs(param_defs)
