"""Distribution substrate (counterpart of ``repro.dist``): logical-axis
sharding rules over ``torch.distributed``'s device meshes, int8 gradient
compression, and GPipe pipeline parallelism."""

from repro_torch.dist import compression, pipeline, sharding

__all__ = ["compression", "pipeline", "sharding"]
