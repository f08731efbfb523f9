"""input_specs(): meta-device stand-ins for every model input
(counterpart of ``repro.launch.specs``).

The reference lowers its steps on ``jax.ShapeDtypeStruct``s; the port's
counterpart is a tensor on torch's ``meta`` device, which has a shape and
a dtype and no storage, so Jamba-1.5-Large-398B's ``train_4k`` state is
described without allocating it anywhere.  The port's trees hold one
leaf a layer where the reference stacks a slot's layers into one leaf:
the element counts and bytes agree, the layouts do not.
"""

from __future__ import annotations

import torch

from repro_torch.common import pytree as pt
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import registry
from repro_torch.train.step import train_state_defs


def _shape(shape: ShapeConfig | str) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def state_defs_for(cfg: ModelConfig, shape: ShapeConfig | str) -> dict:
    """The ParamDef trees that ``input_specs`` makes meta tensors of (and
    that ``launch.mesh.sharding_tree`` places)."""
    shape = _shape(shape)
    if shape.kind == "train":
        return {"state": train_state_defs(cfg),
                "batch": registry.train_batch_defs(cfg, shape)}
    params = registry.layer_defs(cfg)
    cache = registry.cache_defs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return {"params": params, "cache": cache,
                "batch": registry.prefill_batch_defs(cfg, shape)}
    assert shape.kind == "decode", shape.kind
    return {"params": params, "cache": cache,
            "batch": registry.decode_batch_defs(cfg, shape),
            "index": pt.ParamDef((), torch.int32, (), "zeros")}


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str) -> dict:
    """Abstract inputs of the step the shape's kind runs:

    train   -> {"state": train state, "batch": {tokens, targets, ...}}
    prefill -> {"params", "cache", "batch"}
    decode  -> {"params", "cache", "batch", "index"}
    """
    return pt.abstract(state_defs_for(cfg, shape))
