"""Trees of tensors (counterpart of ``repro.common.pytree``): what
training needs of the port's parameter and state trees.

A tree is nested dicts and lists (and tuples) with tensors, numpy
arrays or Python scalars at the leaves, as the port's parameter trees
(``models.transformer``) and train states (``train.step``) are.  Leaves
come in one fixed order: a dict's keys sorted (as JAX flattens a dict),
a list's items in order.  The checkpoint manifest numbers its leaves in
that order.

Models describe their tensors as trees of ``ParamDef`` (shape, dtype,
logical axes, initializer), as the reference's do.  The same tree is
used three ways:

  * ``materialize(defs, generator, device)`` -> real tensors;
  * ``abstract(defs)`` -> tensors on torch's ``meta`` device, the
    counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes with no
    storage, so a 398B model's train state is described without
    allocating it;
  * ``pspec_tree(defs, resolve)`` -> a ``PartitionSpec`` tree
    (``dist.sharding``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

PyTree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(x):
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    return list(enumerate(x))


def tree_leaves(tree: PyTree) -> list:
    """The leaves in the fixed order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for _, c in _children(tree) for leaf in tree_leaves(c)]


def tree_paths(tree: PyTree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's path (keys and indices), in the same order."""
    if not _is_node(tree):
        return [prefix]
    return [p for k, c in _children(tree)
            for p in tree_paths(c, prefix + (k,))]


def tree_path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, c, *(r[i] for r in rest))
               for i, c in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: PyTree, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, c, prefix + (i,))
               for i, c in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(prefix, tree)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One tensor's description.  ``axes``: a logical axis name (or None,
    replicated) per dim, resolved to mesh axes by ``dist.sharding``;
    ``init``: normal (x 0.02) | zeros | ones | scaled (by fan-in, the
    second-to-last dim) | ssm_a (Mamba's ``A_log``: log(1..N) in every
    channel)."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: tuple[str | None, ...] = ()
    init: str = "normal"
    init_scale: float = 1.0

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def init_tensor(d: ParamDef, generator: torch.Generator | None,
                device) -> torch.Tensor:
    """One tensor drawn as ``d.init`` says (a random init draws f32
    normals from ``generator``, then casts)."""
    shape, dtype = d.shape, d.dtype
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if d.init == "ssm_a":
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(shape).to(dtype).contiguous()
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    if d.init == "normal":
        return x.mul_(0.02 * d.init_scale).to(dtype)
    if d.init == "scaled":
        fan_in = shape[-2] if len(shape) >= 2 else max(shape[0], 1)
        return x.mul_(d.init_scale / math.sqrt(fan_in)).to(dtype)
    raise ValueError(f"unknown init {d.init!r}")


def materialize(defs: PyTree, generator: torch.Generator | None = None,
                device="cpu") -> PyTree:
    """Real tensors from a ParamDef tree, drawn from ``generator`` (which
    lives on ``device``) leaf after leaf in the tree's own order (each
    dict's insertion order, as ``tree_map`` walks it): the reference
    folds each leaf's path into its key, so the two packages' bits
    differ."""
    return tree_map(lambda d: init_tensor(d, generator, device), defs)


def abstract(defs: PyTree) -> PyTree:
    """Meta tensors of each leaf's shape and dtype: nothing allocated."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def pspec_tree(defs: PyTree, resolve: Callable) -> PyTree:
    """PartitionSpec tree; ``resolve(axes) -> PartitionSpec``."""
    return tree_map(lambda d: resolve(d.axes), defs)


def _numel(x) -> int:
    return x.size if is_def(x) else int(x.numel())


def param_count(tree: PyTree) -> int:
    """Elements of a tree of tensors or of ParamDefs."""
    return sum(_numel(x) for x in tree_leaves(tree))


def param_bytes(tree: PyTree) -> int:
    return sum(_numel(x) * x.dtype.itemsize for x in tree_leaves(tree))


def cast_floating(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Every floating tensor to ``dtype``; other leaves as they are."""
    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(leaf, tree)
