"""Trees of tensors (counterpart of ``repro.common.pytree``): what
training needs of the port's parameter and state trees.

A tree is nested dicts and lists (and tuples) with tensors, numpy
arrays or Python scalars at the leaves, as the port's parameter trees
(``models.transformer``) and train states (``train.step``) are.  Leaves
come in one fixed order: a dict's keys sorted (as JAX flattens a dict),
a list's items in order.  The checkpoint manifest numbers its leaves in
that order.

The reference's ``ParamDef``, ``materialize``, ``abstract`` and
``pspec_tree`` serve its mesh dry-run and wait for the ``launch/``
slice; ``models.registry.param_defs`` gives the port's shapes and
dtypes.
"""

from __future__ import annotations

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


def param_count(tree: PyTree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def param_bytes(tree: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def cast_floating(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Every floating tensor to ``dtype``; other leaves as they are."""
    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(leaf, tree)
