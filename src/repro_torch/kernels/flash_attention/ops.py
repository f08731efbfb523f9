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

Under a mesh q, k and v arrive as ``DTensor``s (``dist.sharding.shard``
places them ("batch", None, "tp", None)).  ``on_local_heads`` then runs
the call on each rank's local shard: its batch rows and its query heads,
with the kv heads those query heads read (a replicated kv, when the kv
heads do not divide the mesh, is sliced to them), and wraps the local
output back with q's placements.  The kernel (or, on CPU tensors, the
plain version) sees plain tensors only; a ``DTensor`` never reaches it.

On ``meta`` tensors (the dry-run traces a step there) K7 and K7b launch
nothing: they return outputs of the right shapes and dtypes and report
their work (``attention_cost``) to ``_ext.record_cost``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.dist.sharding import (
    from_local_shard,
    is_dtensor,
    local_shard,
    place_offset,
)
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
    autograd through ``FlashAttentionFn`` (K7b or the plain backward).
    ``DTensor`` operands: the same call on each rank's local heads
    (``on_local_heads``)."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return on_local_heads(flash_attention, q, k, v, causal=causal,
                              window=window, q_offset=q_offset, skv=skv)
    skv = int(k.shape[1] if skv is None else skv)
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window=window, q_offset=q_offset, skv=skv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), window,
                                      q_offset, skv)
    return _forward(q, k, v, causal=causal, window=window,
                    q_offset=q_offset, skv=skv)


def on_local_heads(fn, q, k, v, **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` (an attention over [B, S, H, D] and [B, Skv,
    K, D]) on each rank's local shard of ``DTensor`` operands.

    On each mesh dim that shards q's batch (dim 0) every operand takes
    that batch shard; on each that shards q's heads (dim 2) q keeps its
    heads, and k and v are sharded over their kv heads where those
    divide, else replicated; every other mesh dim replicates all three
    (the sequence and head width stay whole).  Local query head i of a
    rank holds global head o + i (o its offset) and reads kv head (o +
    i) // G, G = H / K the global ratio, so a replicated k and v are
    sliced to kv heads o // G .. (o + H_loc - 1) // G: the kernel's own
    grouping over the slice is then the global one.  Gradients of a k or
    v replicated where the call is split are partial sums (``Partial``);
    the output has q's placements."""
    from torch.distributed.tensor import Replicate, Shard

    d = next(t for t in (q, k, v) if is_dtensor(t))
    mesh = d.device_mesh
    qp = q.placements if is_dtensor(q) else [Replicate()] * mesh.ndim
    H, K = q.shape[2], k.shape[2]
    G = H // K
    heads = 1
    for i, p in enumerate(qp):
        if isinstance(p, Shard) and p.dim == 2:
            heads *= mesh.size(i)
    qplace, kplace = [], []
    for p in qp:
        if isinstance(p, Shard) and p.dim == 0:
            qplace.append(Shard(0))
            kplace.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:
            qplace.append(Shard(2))
            kplace.append(Shard(2) if K % heads == 0 else Replicate())
        else:
            qplace.append(Replicate())
            kplace.append(Replicate())
    split = {i for i, p in enumerate(qplace) if not p.is_replicate()}
    ql = local_shard(q, mesh, qplace, split)
    kd = local_shard(k, mesh, kplace, split)
    vd = local_shard(v, mesh, kplace, split)
    qo = place_offset(q.shape, mesh, qplace, 2)
    ko = place_offset(k.shape, mesh, kplace, 2)
    lo, hi = qo // G - ko, (qo + ql.shape[2] - 1) // G + 1 - ko
    if (lo, hi) != (0, kd.shape[2]):
        kd, vd = kd[:, :, lo:hi], vd[:, :, lo:hi]
    out = fn(ql.contiguous(), kd.contiguous(), vd.contiguous(), **kw)
    return from_local_shard(out, mesh, qplace, q.shape)


def live_pairs(Sq: int, skv: int, causal: bool, window: int,
               q_offset: int) -> int:
    """(query, key) pairs the masks keep: the work a call's data needs."""
    n = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(pos, skv - 1) if causal else skv - 1
        lo = max(pos - window + 1, 0) if window else 0
        n += max(hi - lo + 1, 0)
    return n


def attention_cost(q, k, *, causal: bool, window: int, q_offset: int,
                   skv: int, backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one K7 call (``backward``: K7b), as the
    bound column of the port's kernel table counts them: K7 4 D
    operations per live pair per head, Q and O once and the live K and V
    rows once; K7b the five products' 10 D, q, dO and dq, the live K and V
    rows, and dk and dv once."""
    B, Sq, H, D = q.shape
    K, Skv = k.shape[2], k.shape[1]
    pairs = live_pairs(Sq, skv, causal, window, q_offset)
    lo, hi = live_keys(Sq, skv, causal=causal, window=window,
                       q_offset=q_offset)
    kv = 2 * B * (hi - lo) * K * D
    if backward:
        return (10.0 * B * H * D * pairs,
                q.element_size() * (3 * B * Sq * H * D + kv
                                    + 2 * B * Skv * K * D))
    return 4.0 * B * H * D * pairs, q.element_size() * (
        2 * B * Sq * H * D + kv)


def _forward(q, k, v, *, causal: bool, window: int, q_offset: int,
             skv: int) -> torch.Tensor:
    if q.device.type == "meta":
        _ext.record_cost("flash_attention", *attention_cost(
            q, k, causal=causal, window=window, q_offset=q_offset, skv=skv))
        return torch.empty_like(q)
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
        if q.device.type == "meta":
            _ext.record_cost("flash_attention_bwd", *attention_cost(
                q, k, backward=True, **ctx.kw))
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
        elif q.device.type == "cpu":
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
