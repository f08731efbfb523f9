"""Logical-axis sharding rules and the ambient mesh context (counterpart
of ``repro.dist.sharding``).

Models annotate tensors with *logical* axis names ("batch", "tp", ...);
an ``AxisRules`` table maps each logical name to one or more *physical*
mesh axes.  Resolution is mesh-aware: physical axes absent from the
current mesh are dropped (the dim is replicated), and no physical axis is
assigned twice in one spec.

A mesh is anything whose ``.shape`` maps axis names to sizes, or a
``torch.distributed.device_mesh.DeviceMesh`` (read through its
``mesh_dim_names``).  ``mesh_context(mesh, rules)`` installs the ambient
(mesh, rules) pair; ``shard(x, *logical)`` is the identity outside a
context, so model code runs unchanged on one device, and inside a
context on a ``DeviceMesh`` returns a ``DTensor`` placed as the fitted
spec says.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or
    None (replicated); trailing dims past the end are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh whose ``.shape``
    is that mapping already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ------------------------------------------------------------------- rules


class AxisRules:
    """Mapping logical axis name -> physical mesh axis (or tuple of them)."""

    def __init__(self, table: dict[str, str | tuple[str, ...] | None]):
        self.table = dict(table)

    def resolve(self, logical: Sequence[str | None], mesh) -> P:
        """Logical axes -> PartitionSpec valid on ``mesh``.

        * logical names missing from the table resolve to None (replicated);
        * physical axes not present in the mesh are dropped;
        * a physical axis is used at most once per spec (first dim wins);
        * trailing Nones are trimmed.
        """
        sizes = mesh_shape(mesh)
        used: set[str] = set()
        out: list = []
        for name in logical:
            entry = self.table.get(name) if name is not None else None
            if entry is None:
                out.append(None)
                continue
            kept = [a for a in _axes(entry) if a in sizes and a not in used]
            used.update(kept)
            if not kept:
                out.append(None)
            elif len(kept) == 1:
                out.append(kept[0])
            else:
                out.append(tuple(kept))
        while out and out[-1] is None:
            out.pop()
        return P(*out)


# Default: data-parallel batch (over pods too), 1D tensor parallelism on
# "model", FSDP parameter sharding on "data".
DEFAULT_RULES = AxisRules({
    "batch": ("pod", "data"),
    "kv_batch": ("pod", "data"),
    "moe_group": ("pod", "data"),
    "fsdp": "data",
    "tp": "model",
    "ep": "model",
    "sp": None,          # sequence replicated by default
    "vocab": "model",
})

# Prefill: long sequences — shard the sequence dim over the model axis so
# attention working sets fit; weights stay as in DEFAULT_RULES.
PREFILL_RULES = AxisRules({
    **DEFAULT_RULES.table,
    "sp": "model",
})

# Decode for >5B-param models: replicate the (tiny) activations, keep
# weights 2D-sharded over (data, model); KV caches stay batch-sharded.
DECODE_RULES = AxisRules({
    **DEFAULT_RULES.table,
    "batch": None,
    "sp": None,
    "fsdp": "data",
})


# ----------------------------------------------------------- mesh context

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


def current_rules() -> AxisRules:
    return getattr(_STATE, "rules", None) or DEFAULT_RULES


@contextlib.contextmanager
def mesh_context(mesh, rules: AxisRules = DEFAULT_RULES):
    """Install (mesh, rules) as the ambient sharding context."""
    prev = (current_mesh(), getattr(_STATE, "rules", None))
    _STATE.mesh, _STATE.rules = mesh, rules
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.rules = prev


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes the logical axis maps to (1 if no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    entry = current_rules().table.get(logical)
    if entry is None:
        return 1
    sizes = mesh_shape(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes.get(a, 1)
    return n


def _fit_spec(shape: tuple[int, ...], spec: P, mesh) -> P:
    """Drop mesh axes that do not divide their dim (replicate instead)."""
    sizes = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        kept, prod = [], 1
        for a in _axes(entry):
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec: P, mesh) -> list:
    """A fitted spec -> one DTensor placement per mesh dim (in the mesh's
    order): ``Shard(d)`` on each mesh dim named for tensor dim ``d``,
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, entry in enumerate(spec) if entry is not None
              for a in _axes(entry)}
    return [Shard(dim_of[name]) if name in dim_of else Replicate()
            for name in mesh_shape(mesh)]


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` placed on the current mesh as its logical axes resolve (the
    identity without a mesh).  A plain tensor (the same full value on
    every rank) goes through ``distribute_tensor``, a ``DTensor`` through
    ``redistribute``."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError(
            "shard places tensors on a torch.distributed DeviceMesh with "
            f"named dims; the current mesh is a {type(mesh).__name__}")
    from torch.distributed.tensor import DTensor, distribute_tensor

    spec = _fit_spec(tuple(x.shape),
                     current_rules().resolve(logical, mesh), mesh)
    place = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute_tensor(x, mesh, place)
