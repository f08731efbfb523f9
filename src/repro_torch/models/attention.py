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

One card has no mesh, so the reference's sequence-sharded decode reduces
to ``decode_attention_tree``, as it does in JAX without a mesh.

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
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.layers import apply_rope, rmsnorm

BACKENDS = ("cuda", "interpret")

# ------------------------------------------------------------ projections


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(B, S, *w.shape[1:])


def project_q(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    if "q_norm" in p:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


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
    return k, v


def project_out(p: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), times tanh(gate) in the output's dtype
    where the layer has a ``gate`` (a gated cross-attention)."""
    B, S = o.shape[:2]
    wo = p["wo"]
    out = o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


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
    if backend == "cuda":
        return _kernel_attention(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def decode_attention_tree(q, kv: dict, index: int, *, backend: str,
                          window: int = 0) -> torch.Tensor:
    """Decode attention over a (possibly int8) dict cache; ``window``:
    a rolling cache."""
    kc, vc = _materialize_kv(kv)
    if backend != "cuda":
        return decode_attention(q, kc, vc, index, window=window)
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
    ``index % T`` with a window), in place; -> the caches."""
    pos = _start(cache_k.shape[1], k.shape[1], index, window)
    cache_k[:, pos:pos + k.shape[1]] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + v.shape[1]] = v.to(cache_v.dtype)
    return cache_k, cache_v


def cache_update_tree(kv: dict, k: torch.Tensor, v: torch.Tensor,
                      index: int, *, window: int = 0) -> dict:
    """Dict-cache update in place; quantizes on write for int8 caches."""
    if "k_scale" not in kv:
        cache_update(kv["k"], kv["v"], k, v, index, window=window)
        return kv
    pos = _start(kv["k"].shape[1], k.shape[1], index, window)
    end = pos + k.shape[1]
    for name, x in (("k", k), ("v", v)):
        xq, xs = quantize_kv(x)
        kv[name][:, pos:end] = xq
        kv[name + "_scale"][:, pos:end] = xs
    return kv


def _materialize_kv(kv: dict) -> tuple[torch.Tensor, torch.Tensor]:
    if "k_scale" in kv:
        return (dequantize_kv(kv["k"], kv["k_scale"]),
                dequantize_kv(kv["v"], kv["v_scale"]))
    return kv["k"], kv["v"]
