"""Public op: flash attention (counterpart of
``repro.kernels.flash_attention.ops``).

``flash_attention`` launches CUDA kernel K7 for CUDA tensors and runs the
plain version (``ref.attention_ref``) for CPU tensors.  There is no other
switch and no fallback.  K7 picks its kernels by Sq and dtype alone:
Sq <= ``DECODE_MAX_SQ`` the split-KV decode in q's dtype
(``csrc/flash_decode.cu``: two launches, its chunk plan from
``decode_plan``, its partials in a workspace allocated here), longer bf16
calls the tensor-core prefill (``csrc/flash_prefill.cu``: P V on
``wgmma``), longer f32 calls the f32 prefill
(``csrc/flash_prefill_f32.cu``: register-tiled FMA products).
``ref.attention_split_ref`` is the plain form of the kernels'
arithmetic.

Under autograd (grad mode on and an input that requires grad)
``flash_attention`` runs through ``FlashAttentionFn``: its forward is
the same K7 call (or plain version), its backward K7b
(``csrc/flash_backward.cu``, three launches counted as one
``flash_attention_bwd`` call) on CUDA tensors and ``ref.attention_bwd_ref``
on CPU tensors.  Every other call launches exactly what it did before.

Semantics: q [B, Sq, H, D], k and v [B, Skv, K, D] with H % K == 0; the
query at row i sits at position ``q_offset + i``; key t is attended when
``t < skv`` (default Skv), and, with ``causal``, ``t <= q_pos``, and with
``window > 0``, ``t > q_pos - window``.  f32 accumulation, output in q's
dtype.  The kernel masks ragged edges itself, so nothing is padded.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
    live_keys,
)

# K7's head widths (a template parameter; the repo's configs use 16 and 128)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
# calls with at most this many query rows take the split-KV decode
DECODE_MAX_SQ = _ext.header_define("FA_DECODE_MAX_SQ")
# query rows (Sq x the GQA group) per decode block; keys per staged tile
DECODE_ROWS = _ext.header_define("FA_DECODE_ROWS")
DECODE_TILE = _ext.header_define("FA_DECODE_TILE")
# K7b's tile rows: its lse and delta scratch pads Sq to a multiple
BWD_TILE = _ext.header_define("FA_BWD_TILE")
# decode blocks to aim for on each SM (each streams 16 KiB of bf16 K and
# V, or 32 KiB of f32, a 32-key tile through two stages): 2 ran the LM
# path's bf16 decode shapes fastest of 2, 4, 8 and 16 on the H100
DECODE_BLOCKS_PER_SM = 2


def _check(q, k, v, *, window: int, q_offset: int, skv: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Sq, H, D] and k, v one [B, Skv, K, D]"
                         f" shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head width")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} "
                         "kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} is not one K7 takes {HEAD_DIMS}")
    if not 1 <= skv <= k.shape[1]:
        raise ValueError(f"skv={skv} outside 1..{k.shape[1]}")
    if q_offset < 0 or window < 0:
        raise ValueError("q_offset and window must be >= 0")


def decode_plan(B: int, Sq: int, H: int, K: int, skv: int, *,
                causal: bool, window: int, q_offset: int,
                n_sm: int) -> tuple[int, int, int, int]:
    """The split-KV decode's chunks -> (kv_lo, kv_hi, chunk, n_chunks):
    the live keys (``ref.live_keys``) in chunks of whole 32-key tiles, as
    few as give about ``DECODE_BLOCKS_PER_SM`` blocks on each of ``n_sm``
    SMs over the (kv head, row group, batch) blocks."""
    lo, hi = live_keys(Sq, skv, causal=causal, window=window,
                       q_offset=q_offset)
    n_rg = -(-Sq * (H // K) // DECODE_ROWS)
    want = max(1, -(-DECODE_BLOCKS_PER_SM * n_sm // (B * K * n_rg)))
    chunk = DECODE_TILE * -(-(hi - lo) // (want * DECODE_TILE))
    return lo, hi, chunk, -(-(hi - lo) // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    skv: int | None = None) -> torch.Tensor:
    """-> [B, Sq, H, D] in q's dtype.  CUDA tensors: one K7 call; CPU
    tensors: the plain version over the first ``skv`` keys.  Under
    autograd through ``FlashAttentionFn`` (K7b or the plain backward)."""
    skv = int(k.shape[1] if skv is None else skv)
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window=window, q_offset=q_offset, skv=skv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), window,
                                      q_offset, skv)
    return _forward(q, k, v, causal=causal, window=window,
                    q_offset=q_offset, skv=skv)


def _forward(q, k, v, *, causal: bool, window: int, q_offset: int,
             skv: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k[:, :skv], v[:, :skv], causal=causal,
                             window=window, q_offset=q_offset)
    return flash_attention_launch(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, skv=skv)


class FlashAttentionFn(torch.autograd.Function):
    """K7 with its gradient: forward K7 (CPU tensors: ``attention_ref``),
    backward K7b (CPU tensors: ``attention_bwd_ref``).  It saves q, k and
    v only: the backward recomputes the output in f32 (the rounded output
    would put its rounding into delta)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                skv: int):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      skv=skv)
        return _forward(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = attention_bwd_ref(q, k, v, do, **ctx.kw)
        else:
            grads = flash_attention_bwd_launch(q, k, v, do, **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention_launch(q, k, v, *, causal: bool, window: int,
                           q_offset: int, skv: int) -> torch.Tensor:
    """K7's wrapper: checked operands -> the output, on the current
    stream: one launch, or the split-KV decode's two (counted as one
    call)."""
    _check(q, k, v, window=window, q_offset=q_offset, skv=skv)
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention_launch runs CUDA tensors of "
                             f"one device; got {t.device} beside {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError("q, k and v must share one dtype of "
                             f"{DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention_launch takes contiguous "
                             "tensors")
        if t.data_ptr() % 16:              # 16-byte loads a thread
            raise ValueError("flash_attention_launch needs tensors aligned "
                             "to 16 bytes")
    out = torch.empty_like(q)
    B, Sq, H, D = q.shape
    K = k.shape[2]
    plan, ws = (0, 0, 0, 0), q.new_empty(0, dtype=torch.float32)
    if Sq <= DECODE_MAX_SQ:
        plan = decode_plan(B, Sq, H, K, skv, causal=causal, window=window,
                           q_offset=q_offset, n_sm=_sm_count(q.device))
        ws = q.new_empty(B * K * plan[3] * Sq * (H // K) * (D + 2),
                         dtype=torch.float32)
    _ext.extension().flash_attention(q, k, v, out, ws, skv, q_offset,
                                     bool(causal), window, *plan)
    _ext.count_launch("flash_attention")
    return out


def flash_attention_bwd_launch(q, k, v, do, *, causal: bool, window: int,
                               q_offset: int, skv: int):
    """K7b's wrapper: checked operands and dO -> (dq, dk, dv) in their
    dtypes, on the current stream: three launches (stats, dK/dV, dQ;
    bf16 on ``wgmma`` tensor cores, f32 on the CUDA cores) counted as one
    call; keys past ``skv`` take zero gradients."""
    _check(q, k, v, window=window, q_offset=q_offset, skv=skv)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    for t in (q, k, v, do):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention_bwd_launch runs CUDA tensors "
                             f"of one device; got {t.device} beside "
                             f"{q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError("q, k, v and dO must share one dtype of "
                             f"{DTYPES}; got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}, {do.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd_launch takes contiguous "
                             "tensors aligned to 16 bytes")
    B, Sq, H, _ = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = q.new_empty((B, H, -(-Sq // BWD_TILE) * BWD_TILE),
                      dtype=torch.float32)
    delta = torch.empty_like(lse)
    _ext.extension().flash_attention_bwd(q, k, v, do, lse, delta, dq, dk, dv,
                                         skv, q_offset, bool(causal), window)
    _ext.count_launch("flash_attention_bwd")
    return dq, dk, dv
