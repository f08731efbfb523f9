"""Public op: flash attention (counterpart of
``repro.kernels.flash_attention.ops``).

``flash_attention`` launches CUDA kernel K7 (``csrc/flash_attention.cu``)
for CUDA tensors and runs the plain version (``ref.attention_ref``) for
CPU tensors.  There is no other switch and no fallback.

Semantics: q [B, Sq, H, D], k and v [B, Skv, K, D] with H % K == 0; the
query at row i sits at position ``q_offset + i``; key t is attended when
``t < skv`` (default Skv), and, with ``causal``, ``t <= q_pos``, and with
``window > 0``, ``t > q_pos - window``.  f32 accumulation, output in q's
dtype.  The kernel masks ragged edges itself, so nothing is padded.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.flash_attention.ref import attention_ref

# K7's head widths (a template parameter; the repo's configs use 16 and 128)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    skv: int | None = None) -> torch.Tensor:
    """-> [B, Sq, H, D] in q's dtype.  CUDA tensors: one K7 launch; CPU
    tensors: the plain version over the first ``skv`` keys."""
    skv = int(k.shape[1] if skv is None else skv)
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window=window, q_offset=q_offset, skv=skv)
    if q.device.type == "cpu":
        return attention_ref(q, k[:, :skv], v[:, :skv], causal=causal,
                             window=window, q_offset=q_offset)
    return flash_attention_launch(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, skv=skv)


def flash_attention_launch(q, k, v, *, causal: bool, window: int,
                           q_offset: int, skv: int) -> torch.Tensor:
    """K7's wrapper: checked operands -> the output, one launch on the
    current stream."""
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
        # the kernel loads element pairs
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError("flash_attention_launch needs tensors aligned "
                             "to two elements")
    out = torch.empty_like(q)
    _ext.extension().flash_attention(q, k, v, out, skv, q_offset,
                                     bool(causal), window)
    _ext.count_launch("flash_attention")
    return out
