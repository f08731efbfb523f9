"""Optimizers (counterpart of ``repro.optim.optimizers``): AdamW and
Adafactor, written out per tensor with the reference's expression order.

``update(grads, state, params, lr, step)`` updates ``state`` and
``params`` in place and returns them (the reference returns new trees and
donates the old ones; at Qwen3-1.7B's width a second copy of the master
weights and moments would be 20 GB).  ``lr`` and ``step`` are 0-dim
tensors (``step`` an int).  ``state_defs(param_defs)`` takes a
``ParamDef`` tree and gives the state's (f32 zeros on the parameter's
axes), as ``launch.specs`` describes a train state without allocating
it.

Adafactor's update clip and relative step take the RMS of a whole
leaf.  The reference's leaves are scan-stacked over a stack's periods, so
its RMS runs over every layer of a slot; ``group_of(path)`` (None: each
leaf alone) names the leaves that share those statistics, and
``train.step`` passes the stacking of the port's per-layer tree.  The
reference also factors the second moment of a stacked [n, d] leaf (a
per-layer 1-D leaf over n > 1 periods) into vr [n] and vc [d]; the port
holds it so (a 0-dim ``vr`` a layer, ``vc`` on the group's first layer).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.pytree import (
    ParamDef,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_paths,
)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable        # params -> opt_state
    update: Callable      # (grads, state, params, lr, step) -> (params, state)
    state_defs: Callable  # param ParamDef tree -> opt_state's


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


# ----------------------------------------------------------------- AdamW


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        def zero(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)

        return {"m": tree_map(zero, params), "v": tree_map(zero, params)}

    def state_defs(defs):
        f32 = lambda d: ParamDef(d.shape, F32, d.axes, "zeros")  # noqa: E731
        return {"m": tree_map(f32, defs), "v": tree_map(f32, defs)}

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
    def groups(tree) -> list[list]:
        out = {}
        for path in tree_paths(tree):
            key = path if group_of is None else group_of(path)
            out.setdefault(key, []).append(path)
        return list(out.values())

    def stacked(members, shape) -> bool:
        """A group of per-layer 1-D [d] leaves that the reference stacks
        into one [n, d] leaf and factors (n, d > 1): the group's second
        moment is vr [n] (one 0-dim ``vr`` a member) and vc [d] (held by
        the group's first member), as the reference's."""
        return len(shape) == 1 and _factored((len(members),) + tuple(shape))

    def moments(tree, shape_of, axes_of, make):
        rows = {path: k for members in groups(tree)
                if stacked(members, shape_of(_get(tree, members[0])))
                for k, path in enumerate(members)}

        def leaf(path, x):
            s = tuple(shape_of(x))
            ax = axes_of(x) or (None,) * len(s)
            if path in rows:
                return ({"vr": make((), ()), "vc": make(s, ax)}
                        if rows[path] == 0 else {"vr": make((), ())})
            if _factored(s):
                return {"vr": make(s[:-1], ax[:-1]),
                        "vc": make(s[:-2] + s[-1:], ax[:-2] + ax[-1:])}
            return {"v": make(s, ax)}

        return {"f": tree_map_with_path(leaf, tree)}

    def init(params):
        dev = tree_leaves(params)[0].device
        return moments(params, lambda p: p.shape, lambda p: (),
                       lambda s, ax: torch.zeros(s, dtype=F32, device=dev))

    def state_defs(defs):
        return moments(defs, lambda d: d.shape, lambda d: d.axes,
                       lambda s, ax: ParamDef(s, F32, ax, "zeros"))

    def stacked_updates(members, grads, state, beta2):
        """The f32 updates of a ``stacked`` group, as the reference's
        factored update of the stacked leaf."""
        g = torch.stack([_get(grads, path).to(F32) for path in members])
        g2 = torch.square(g) + eps
        vr = torch.stack([_get(state["f"], path)["vr"] for path in members])
        vc = _get(state["f"], members[0])["vc"]
        vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
        vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
        for path, row in zip(members, vr):
            _get(state["f"], path)["vr"].copy_(row)
        denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
        vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
        return list((g * torch.rsqrt(vhat + eps)).unbind(0))

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        # one group at a time: its leaves' second moments and f32 updates,
        # the group's sums of squares, then its leaves updated, so that
        # only the largest group's updates are held at once (every leaf's
        # at once would be twice the bf16 weights)
        t = step.to(F32) + 1.0
        beta2 = 1.0 - t ** (-decay_pow)
        for members in groups(params):
            rows = (stacked_updates(members, grads, state, beta2)
                    if stacked(members, _get(params, members[0]).shape)
                    else None)
            upds, n, su, sp = [], 0, 0.0, 0.0
            for k, path in enumerate(members):
                if rows is not None:
                    upd = rows[k]
                else:
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


def get_optimizer(name: str, group_of: Callable | None = None) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor(group_of=group_of)
    raise ValueError(name)


def opt_state_defs(name: str, param_defs) -> Any:
    return get_optimizer(name).state_defs(param_defs)
