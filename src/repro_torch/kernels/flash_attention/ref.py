"""Plain PyTorch versions of K7 (counterpart of
``repro.kernels.flash_attention.ref``).  ``attention_ref``: naive
full-matrix softmax attention with causal masking, a sliding window, GQA
(H % K == 0) and a q position offset.  ``attention_split_ref``: the same
function by the arithmetic of K7's kernels (chunks of the live keys,
tiles, the online softmax and the combine; in the bf16 prefill P split
into bf16 hi and lo).  ``attention_bwd_ref``: the gradient of
``attention_ref`` by the arithmetic of K7b, K7's backward kernel (with
``split_p`` that of its bf16 kernels: P and dS split into bf16 hi and lo).
The CPU tests hold both against the reference, and ``chip_smoke.py``
holds the kernels against both on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, K, D] -> [B, Sq, H, D] in q's dtype,
    computed in f32."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    s = s / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def live_keys(Sq: int, skv: int, *, causal: bool, window: int,
              q_offset: int) -> tuple[int, int]:
    """[lo, hi): the keys that some query row of a call may attend — up to
    the last row's position under ``causal``, above the first row's
    ``q_offset - window`` under a window, below ``skv`` — or every key
    [0, skv) when that range is empty (every key is masked then, and the
    softmax averages them all, as ``attention_ref`` does)."""
    hi = min(skv, q_offset + Sq) if causal else skv
    lo = max(q_offset - window + 1, 0) if window > 0 else 0
    return (lo, hi) if lo < hi else (0, skv)


def _prod(eq: str, x: torch.Tensor, y: torch.Tensor,
          split_p: bool) -> torch.Tensor:
    """einsum(eq, x, y); with ``split_p`` as x_hi y + x_lo y, x_hi =
    bf16(x) and x_lo = bf16(x - x_hi) (about 2^-16 of x from f32): how
    the bf16 kernels take P (and K7b dS) into the tensor cores."""
    if not split_p:
        return torch.einsum(eq, x, y)
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, lo: int = 0,
                        hi: int | None = None, chunk: int | None = None,
                        tile: int = 64, split_p: bool = False
                        ) -> torch.Tensor:
    """The arithmetic of K7's kernels, in plain PyTorch: keys [lo,
    hi) (default every key of k) in chunks of ``chunk`` keys (default one
    chunk), each walked in tiles of ``tile`` keys with the TPU kernel's
    online softmax — the scale after the dot, the masks to NEG_INF, alpha
    = exp(m_prev - m_new) — the chunks' partial (m, l, acc) merged with
    the same alpha, and acc / max(l, 1e-30).  The bf16 prefill is one
    chunk of 64-key tiles with ``split_p`` (its P V on the tensor cores),
    the f32 prefill one chunk of 64-key tiles without; the split-KV
    decode, bf16 or f32, is the wrapper's chunks of 32-key tiles.  Keys
    outside [lo, hi) take no part.
    q [B, Sq, H, D]; k, v [B, Skv, K, D] -> q's dtype, computed in f32."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    hi = k.shape[1] if hi is None else hi
    chunk = hi - lo if chunk is None else chunk
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    qg = q.reshape(B, Sq, K, G, D).to(f32)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    parts = []
    for c_lo in range(lo, hi, chunk):
        m = torch.full((B, K, G, Sq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, G, Sq, D), dtype=f32, device=q.device)
        c_hi = min(c_lo + chunk, hi)
        for t_lo in range(c_lo, c_hi, tile):
            t_hi = min(t_lo + tile, c_hi)
            vt = v[:, t_lo:t_hi].to(f32)
            s = torch.einsum("bskgd,btkd->bkgst", qg,
                             k[:, t_lo:t_hi].to(f32)) * scale
            kv_pos = torch.arange(t_lo, t_hi, device=q.device)
            mask = torch.ones((Sq, t_hi - t_lo), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            acc = acc * alpha[..., None] + _prod("bkgst,btkd->bkgsd", p,
                                                 vt, split_p)
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_c, l_c, acc_c in parts:
        alpha = torch.exp(m_c - m)
        l = l + l_c * alpha
        acc = acc + acc_c * alpha[..., None]
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def first_masked_row(Sq: int, skv: int, *, window: int,
                     q_offset: int) -> int:
    """The first query row whose keys are all masked (Sq: none).  Only a
    window past skv masks a whole row (the causal mask keeps the row's
    own position), and then every later row too."""
    if window <= 0:
        return Sq
    return min(max(skv + window - 1 - q_offset, 0), Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0,
                      skv: int | None = None, tile: int = 64,
                      split_p: bool = False):
    """The gradient of ``attention_ref(q, k[:, :skv], v[:, :skv])``
    against ``do`` by K7b's arithmetic, in f32: (1) the stats, K7's
    online softmax over ``tile``-key tiles of the live keys with O
    recomputed in f32, lse = m + log(l) and delta = sum_d dO * O (+inf
    and 0 for a fully masked row); (2) per key tile p = exp(s - lse) (0
    where masked), dS = p * (dP - delta), dV += p^T dO, dK += dS^T Q,
    dQ += dS K, dK and dQ times the scale at the end; (3) a fully masked
    row's uniform softmax: dV += its dO / skv on every key < skv.  With
    ``split_p`` the accumulating products (O += P V, dV, dK, dQ) take P
    and dS as bf16 hi + lo, two products each: the schedule of K7b's
    bf16 kernels, whose products run on the tensor cores.
    -> (dq, dk, dv) in q's, k's and v's dtypes; keys past skv take 0."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    skv = Skv if skv is None else int(skv)
    G = H // K
    f32 = torch.float32
    dev = q.device
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    qg = q.reshape(B, Sq, K, G, D).to(f32)
    dog = do.reshape(B, Sq, K, G, D).to(f32)
    kf, vf = k[:, :skv].to(f32), v[:, :skv].to(f32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    lo, hi = live_keys(Sq, skv, causal=causal, window=window,
                       q_offset=q_offset)
    r_fm = first_masked_row(Sq, skv, window=window, q_offset=q_offset)
    fm = torch.arange(Sq, device=dev) >= r_fm

    def tile_mask(t_lo: int, t_hi: int) -> torch.Tensor:
        kv_pos = torch.arange(t_lo, t_hi, device=dev)
        mask = torch.ones((Sq, t_hi - t_lo), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        return mask

    # the kernel's tiles: multiples of ``tile`` (tiles whose keys are all
    # masked for a row change nothing of it)
    tiles = [(t, min(t + tile, hi)) for t in range(lo - lo % tile, hi, tile)]
    # (1) the stats
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, D), dtype=f32, device=dev)
    for t_lo, t_hi in tiles:
        s = torch.einsum("bskgd,btkd->bkgst", qg, kf[:, t_lo:t_hi]) * scale
        s = torch.where(tile_mask(t_lo, t_hi), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + _prod(
            "bkgst,btkd->bkgsd", p, vf[:, t_lo:t_hi], split_p)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    dob = dog.permute(0, 2, 3, 1, 4)                     # [B, K, G, Sq, D]
    delta = torch.where(fm, 0.0, (dob * o).sum(-1))
    lse = torch.where(fm, torch.inf, m + torch.log(l))
    # (2) the gradients, key tile by key tile
    dq = torch.zeros((B, K, G, Sq, D), dtype=f32, device=dev)
    dk = torch.zeros((B, Skv, K, D), dtype=f32, device=dev)
    dv = torch.zeros((B, Skv, K, D), dtype=f32, device=dev)
    for t_lo, t_hi in tiles:
        kt, vt = kf[:, t_lo:t_hi], vf[:, t_lo:t_hi]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kt) * scale
        p = torch.where(tile_mask(t_lo, t_hi), torch.exp(s - lse[..., None]),
                        0.0)
        dp = torch.einsum("bskgd,btkd->bkgst", dog, vt)
        ds = p * (dp - delta[..., None])
        dv[:, t_lo:t_hi] = _prod("bkgst,bskgd->btkd", p, dog, split_p)
        dk[:, t_lo:t_hi] = _prod("bkgst,bskgd->btkd", ds, qg,
                                 split_p) * scale
        dq = dq + _prod("bkgst,btkd->bkgsd", ds, kt, split_p)
    dq = dq * scale
    # (3) the fully masked rows
    if r_fm < Sq:
        u = dog[:, r_fm:].sum(dim=(1, 3))                # [B, K, D]
        dv[:, :skv] = dv[:, :skv] + u[:, None] / skv
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
