"""Production mesh construction (counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is built with ``init_device_mesh`` over the ranks
of the default process group (``launch.multihost.init_distributed``),
and its size must be the world size: it is never shrunk to fit.
"""

from __future__ import annotations

import math

from repro_torch.common import pytree as pt
from repro_torch.dist.sharding import (
    DEFAULT_RULES,
    AxisRules,
    _fit_spec,
    placements,
)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh_shape(shape: tuple[int, ...], axes: tuple[str, ...],
                    device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` on the
    run's ``device_type`` ("cuda", "cpu" over gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    n, world = math.prod(shape), _world_size()
    if n != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {axes} needs {n} ranks; "
            f"the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single pod (256 devices) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device_type)


def fit_pspec(shape: tuple[int, ...], spec, mesh):
    """Drop mesh axes that do not divide their dim (replicate instead).

    E.g. GQA with 8 KV heads on a 16-way model axis: the KV projection is
    replicated across pairs of TP ranks — the standard fallback on real
    systems — rather than failing.
    """
    return _fit_spec(tuple(shape), spec, mesh)


def sharding_tree(defs, mesh, rules: AxisRules = DEFAULT_RULES):
    """ParamDef tree -> a tree of DTensor placements (one per mesh dim;
    logical axes resolved, then fitted to the shape)."""
    return pt.tree_map(
        lambda d: placements(
            fit_pspec(d.shape, rules.resolve(d.axes, mesh), mesh), mesh),
        defs)


def place_tree(tree, defs, mesh, rules: AxisRules = DEFAULT_RULES):
    """A tree of tensors holding the same full value on every rank ->
    ``DTensor``s on ``mesh`` placed as ``sharding_tree(defs, mesh,
    rules)`` says (each rank keeps its own shard)."""
    from torch.distributed.tensor import distribute_tensor

    return pt.tree_map(lambda x, place: distribute_tensor(x, mesh, place),
                       tree, sharding_tree(defs, mesh, rules))
