"""Layer primitives (counterpart of ``repro.models.layers``): RMSNorm,
RoPE, the MLPs and the tied or untied embedding.  Parameters are plain
dicts of tensors with the reference's names and layouts; each function
keeps the reference's expression order and compute dtypes, and its
activations carry the reference's ``dist.sharding.shard`` annotations
(the identity without a mesh)."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor, shard


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32, times ``scale``, cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"]).to(dtype)


def _out_of_place(x: torch.Tensor) -> bool:
    """Whether an activation must run out of place: under autograd, and
    on a ``DTensor`` (a partial sum takes no in-place exp)."""
    return (x.requires_grad and torch.is_grad_enabled()) or is_dtensor(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the reference evaluates it: x * logistic(x), XLA
    expanding the logistic to 1 / (1 + exp(-x)) with every operation
    rounded in x's dtype.  In bf16 that rounding is the result: torch's
    fused silu (rounded once) moves about a third of the values by one
    step from it, and the expansion matches it bit for bit.  In f32 the
    two differ from the reference only where the frameworks' exp differ
    in the last bit, and the fused silu, one rounding, stays the
    closer.  Outside autograd, on a plain tensor, the five ops run in place on one buffer:
    the same bits, and less host time a call (``tools/silu_cost.py``)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    if _out_of_place(x):
        return x * torch.reciprocal(1 + torch.exp(-x))
    return torch.neg(x).exp_().add_(1).reciprocal_().mul_(x)


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple:
    """jax.nn.gelu's constants in ``dtype``: sqrt(2 / pi) (rounded to f32
    first, as numpy's ``astype`` from the f32 it is computed in), 0.044715
    and 0.5, each a 0-dim CPU tensor (a scalar to an op on any device)."""
    k = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(dtype)
    return k, torch.tensor(0.044715, dtype=dtype), torch.tensor(0.5,
                                                                dtype=dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (its tanh form, the default) as the reference evaluates
    it: x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x^3)))), x^3
    as x * (x * x), every operation rounded in x's dtype with the
    constants first rounded to it.  In bf16 that rounding is the result:
    torch's fused gelu (rounded once) moves about 43 % of the values by a
    step from it, and the expansion matches it bit for bit.  In f32 both
    lie within the last bit of the reference, and the fused gelu, one
    rounding, is kept.  Outside autograd the ops run in place on one
    buffer: the same bits."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    k, c, half = _gelu_constants(x.dtype)
    if _out_of_place(x):
        return x * (half * (1 + torch.tanh(k * (x + c * (x * x * x)))))
    return (x * x).mul_(x).mul_(c).add_(x).mul_(k).tanh_().add_(1).mul_(
        half).mul_(x)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, Dh]; positions broadcastable to [..., S].  Rotates
    the two halves of each head (not interleaved pairs), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]           # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (``act="silu"``: wg, wu, wd) or the biased two-projection
    MLP with the tanh-approximated gelu (jax.nn.gelu's default)."""
    if act == "silu":
        h = silu(x @ p["wg"]) * (x @ p["wu"])
        h = shard(h, "batch", "sp", "tp")
        return h @ p["wd"]
    h = gelu((x @ p["wi"]) + p["bi"].to(x.dtype))
    h = shard(h, "batch", "sp", "tp")
    return (h @ p["wd"]) + p["bd"].to(x.dtype)


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """The table's rows.  A ``DTensor`` table goes through
    ``F.embedding``, which has a sharding rule where indexing has none:
    over a vocabulary split across ranks each rank looks up its own rows
    and the masked partial rows are summed (reduced to replicated first:
    the masked partial has no direct path to a sequence shard)."""
    table = p["table"]
    if not is_dtensor(table):
        return shard(table[ids.long()], "batch", "sp", None)
    from torch.distributed.tensor import Replicate

    x = F.embedding(ids.long(), table)
    x = x.redistribute(x.device_mesh, [Replicate() if q.is_partial() else q
                                       for q in x.placements])
    return shard(x, "batch", "sp", None)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        logits = x @ p["unembed"]
    else:
        logits = x @ p["table"].T
    return shard(logits, "batch", "sp", "tp")
