"""Attention (counterpart of ``repro.models.attention``): the GQA/MHA
projections with RoPE, QKV bias and QK-norm, the tanh gate of a gated
cross-attention, decode attention against a cache, and the full, int8
and rolling-window KV caches.

Two attention engines, chosen by ``backend``:

  * ``"cuda"``: K7 (``kernels.flash_attention``) for every call:
    prefill (causal, q_offset 0, the config's sliding window), the
    encoder's and cross-attention's non-causal calls (over every key of
    the memory), and decode (Sq = 1 against the cache: causal, q_offset
    = the cache index, skv = the cache length, exactly
    ``decode_attention``'s ``slot <= index`` mask; against a rolling
    window cache non-causal with skv = min(index + 1, T), exactly its
    ``slot < n_written`` mask).  On CPU tensors K7's plain version runs.
  * ``"interpret"``: the plain versions, ``attention_ref`` for prefill
    and ``decode_attention`` for decode, on any device.

Under a mesh the projections carry the reference's ``shard``
annotations (q, k and v ("batch", None, "tp", None), the output
("batch", "sp", None)) and both engines run on each rank's local heads
(``kernels.flash_attention.on_local_heads``): the reference's
head-sharded layout (``repro/models/attention.py:130-172``), with each
rank reading the kv heads its query heads use.  The reference's
sequence-sharded decode (a partial softmax on each rank's slice of the
cache, combined by a psum) is not ported: a cache sharded over its
sequence is gathered to the ranks' heads before the call, and the
result is the same attention.  Without a mesh it reduces to
``decode_attention_tree``, as it does in JAX.

Caches are updated in place (the reference returns updated copies): the
engine's cache is the largest tensor it holds, and the forward writes
one position per layer per decode step.  A sliding-window cache holds
T = min(max_seq, window) positions; decode writes position ``index`` at
slot ``index % T``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.pytree import ParamDef
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import is_dtensor, shard, write_rows
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    on_local_heads,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.layers import apply_rope, rmsnorm

BACKENDS = ("cuda", "interpret")

# ------------------------------------------------------------ projections


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    B, S, _ = x.shape
    y = x @ _flat_heads(w, 1)
    return _heads_divide(y, w.shape[1], 2).reshape(B, S, *w.shape[1:])


def _heads_divide(y: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """``y`` with dim ``dim`` (heads x their width, flattened) made whole
    along each mesh dim that shards it and that ``heads`` does not
    divide, so that it splits into [heads, width] (DTensor's view rules
    refuse to unflatten a shard across the heads); a plain tensor as it
    is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    place = [Replicate() if isinstance(p, Shard) and p.dim == dim
             and heads % mesh.size(i) else p
             for i, p in enumerate(y.placements)]
    return y if place == list(y.placements) else y.redistribute(mesh, place)


class _FlatHeads(torch.autograd.Function):
    """A ``DTensor`` with dims (dim, dim + 1), heads and their width,
    flattened; its gradient is made whole along the mesh dims the head
    count does not divide (``_heads_divide``) before it takes the
    input's shape again."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.shape, ctx.dim = x.shape, dim
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        g = _heads_divide(g, ctx.shape[ctx.dim], ctx.dim)
        return g.reshape(ctx.shape), None


def _flat_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x's dims (dim, dim + 1) flattened (``_FlatHeads`` on a
    ``DTensor``)."""
    if is_dtensor(x):
        return _FlatHeads.apply(x, dim)
    return x.flatten(dim, dim + 1)


def project_q(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    if "q_norm" in p:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return shard(q, "batch", None, "tp", None)


def project_kv(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor | None = None):
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if "k_norm" in p:
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    if positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    k = shard(k, "batch", None, "tp", None)
    v = shard(v, "batch", None, "tp", None)
    return k, v


def project_out(p: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), times tanh(gate) in the output's dtype
    where the layer has a ``gate`` (a gated cross-attention)."""
    out = _flat_heads(o, 2) @ _flat_heads(p["wo"], 0)
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return shard(out, "batch", "sp", None)


# ------------------------------------------------------------- core math


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: int, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention against a [B, T, K, D] cache, valid positions
    <= index; with ``window`` (a rolling cache, position p at slot p %
    T) every written slot, slot < min(index + 1, T).  In f32, output in
    q's dtype."""
    B, Sq, H, D = q.shape
    K = k_cache.shape[2]
    T = k_cache.shape[1]
    qg = q.reshape(B, Sq, K, H // K, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     k_cache.to(torch.float32)) / math.sqrt(D)
    slot = torch.arange(T, device=q.device)
    valid = slot < min(index + 1, T) if window > 0 else slot <= index
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v_cache.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _plain(fn, q, k, v, **kw) -> torch.Tensor:
    """A plain attention ``fn``; on ``DTensor`` operands on each rank's
    local heads, as the kernel runs."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return on_local_heads(fn, q, k, v, **kw)
    return fn(q, k, v, **kw)


def _head_layout(q, k, v):
    """The reference's head-major annotations of its prefill attention
    (``chunked_attention``): q, k and v with their heads over "tp" and
    their batch over "batch", set on [B, H, S, D] views.  k and v keep
    their K heads (the reference repeats them to H first), so where K
    does not divide the axis they stay replicated and each rank's call
    takes the kv heads its query heads read.  The reference's score and
    accumulator annotations have no counterpart: the attention is one
    call on each rank's local heads, with no global score tensor."""
    def heads(x):
        return shard(x.transpose(1, 2), "batch", "tp", None,
                     None).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _kernel_attention(q, k, v, **kw) -> torch.Tensor:
    """K7 on q, k, v; operands of mixed dtypes (an f32 q against a bf16
    or dequantized cache) go in as f32, as the reference's f32 math
    takes them, and the output comes back in q's dtype."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        f32 = torch.float32
        return flash_attention(q.to(f32), k.to(f32), v.to(f32),
                               **kw).to(q.dtype)
    return flash_attention(q, k, v, **kw)


def prefill_attention(q, k, v, *, backend: str, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """Attention over the whole sequence from position 0: causal
    self-attention (with the config's sliding ``window``), or, with
    ``causal=False``, the encoder's self-attention and cross-attention
    over every key of the memory."""
    q, k, v = _head_layout(q, k, v)
    if backend == "cuda":
        return _kernel_attention(q, k, v, causal=causal, window=window)
    return _plain(attention_ref, q, k, v, causal=causal, window=window)


def decode_attention_tree(q, kv: dict, index: int, *, backend: str,
                          window: int = 0) -> torch.Tensor:
    """Decode attention over a (possibly int8) dict cache; ``window``:
    a rolling cache."""
    kc, vc = _materialize_kv(kv)
    if backend != "cuda":
        return _plain(decode_attention, q, kc, vc, index=index,
                      window=window)
    if window > 0:
        return _kernel_attention(q, kc, vc, causal=False,
                                 skv=min(index + 1, kc.shape[1]))
    return _kernel_attention(q, kc, vc, causal=True, q_offset=index,
                             skv=kc.shape[1])


# ---------------------------------------------------------------- caches


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int,
               n_layers: int) -> dict:
    """{name: ParamDef} of the stacked [L, B, T, K, D] KV cache, T =
    min(max_seq, sliding_window) with a window, else max_seq;
    ``kv_cache_dtype == "int8"`` stores symmetric per-(token, head)
    quantized keys and values with f32 scales.  The axes are the
    reference's: the sequence dim on "sp" where ``decode_seq_shard`` and
    no window."""
    T = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
         else max_seq)
    seq_axis = ("sp" if cfg.decode_seq_shard and not cfg.sliding_window
                else None)
    shape = (n_layers, batch, T, cfg.num_kv_heads, cfg.head_dim)
    axes = (None, "kv_batch", seq_axis, None, None)

    def zeros(s, dt, ax):
        return ParamDef(s, dt, ax, "zeros")

    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros(shape, torch.int8, axes),
                "v": zeros(shape, torch.int8, axes),
                "k_scale": zeros(shape[:-1], torch.float32, axes[:-1]),
                "v_scale": zeros(shape[:-1], torch.float32, axes[:-1])}
    return {"k": zeros(shape, torch.bfloat16, axes),
            "v": zeros(shape, torch.bfloat16, axes)}


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, K, D] -> (int8 [B, S, K, D], f32 scale [B, S, K]); rounds
    half to even, as jnp.round."""
    x = x.to(torch.float32)
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _start(T: int, S: int, index: int, window: int = 0) -> int:
    """The write position (``index % T`` with a window), clamped as
    dynamic_update_slice clamps it."""
    index = int(index) % T if window > 0 else int(index)
    return min(max(index, 0), T - S)


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, index: int, *,
                 window: int = 0):
    """Write k, v [B, S, K, D] into [B, T, K, D] caches at ``index`` (at
    ``index % T`` with a window), in place; -> the caches.  A cache
    sharded over its sequence takes on each rank the rows of its own
    shard (``dist.sharding.write_rows``)."""
    pos = _start(cache_k.shape[1], k.shape[1], index, window)
    write_rows(cache_k, k, 1, pos)
    write_rows(cache_v, v, 1, pos)
    return cache_k, cache_v


def cache_update_tree(kv: dict, k: torch.Tensor, v: torch.Tensor,
                      index: int, *, window: int = 0) -> dict:
    """Dict-cache update in place; quantizes on write for int8 caches."""
    if "k_scale" not in kv:
        cache_update(kv["k"], kv["v"], k, v, index, window=window)
        return kv
    pos = _start(kv["k"].shape[1], k.shape[1], index, window)
    for name, x in (("k", k), ("v", v)):
        xq, xs = quantize_kv(x)
        write_rows(kv[name], xq, 1, pos)
        write_rows(kv[name + "_scale"], xs, 1, pos)
    return kv


def _materialize_kv(kv: dict) -> tuple[torch.Tensor, torch.Tensor]:
    if "k_scale" in kv:
        return (dequantize_kv(kv["k"], kv["k_scale"]),
                dequantize_kv(kv["v"], kv["v_scale"]))
    return kv["k"], kv["v"]
