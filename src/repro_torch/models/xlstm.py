"""xLSTM blocks (counterpart of ``repro.models.xlstm``): the mLSTM
(matrix memory, exponential gating), chunkwise over the sequence and
one recurrence step at S = 1, and the sequential sLSTM.

Plain PyTorch: the reference has no kernel for either block (its
``xlstm.py`` is jnp), so nothing here stands in for one.  Every gate is
computed in f32 in log space with the reference's stabilizers, in its
expression order (Appendix A of arXiv:2405.04517): m_new = max(lf + m0,
li); the denominator clamped by exp(-m); sLSTM's per-head max over the
head dim; its normalizer max(n, 1).

The mLSTM prefill runs chunks of L = min(128, S) steps, carrying the
stabilized (C, n, m) state across them, and refuses an S that L does not
divide, as the reference does (``check_length``).  The reference's
train-only unrolled sLSTM scan changes no numbers, so the sLSTM here is
one loop over S.  The mLSTM's conv state is kept in bf16, as the
reference keeps it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard
from repro_torch.models.layers import silu

F32, BF16 = torch.float32, torch.bfloat16
NEG_INF = -1e30
CHUNK = 128   # the reference's mLSTM chunk (repro/models/xlstm.py:73)


def check_length(S: int, chunk: int = CHUNK) -> None:
    """Raises for a sequence length the chunkwise mLSTM refuses."""
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"an mLSTM over S={S}: the reference runs chunks of "
                         f"min({chunk}, S) = {L} and refuses a length that "
                         "is not a multiple of it")


# ================================================================ mLSTM


def mlstm_defs(cfg: ModelConfig) -> dict:
    """{name: ParamDef} of one mLSTM mixer."""
    d, HD, H = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_heads
    return {
        "wq": ParamDef((d, HD), BF16, ("fsdp", "tp"), "scaled"),
        "wk": ParamDef((d, HD), BF16, ("fsdp", "tp"), "scaled"),
        "wv": ParamDef((d, HD), BF16, ("fsdp", "tp"), "scaled"),
        "wz": ParamDef((d, HD), BF16, ("fsdp", "tp"), "scaled"),
        "wo": ParamDef((HD, d), BF16, ("tp", "fsdp"), "scaled"),
        "w_if": ParamDef((d, 2 * H), F32, ("fsdp", None), "scaled"),
        "b_if": ParamDef((2 * H,), F32, (None,), "zeros"),
        "conv_w": ParamDef((4, HD), BF16, (None, "tp"), "scaled"),
        "conv_b": ParamDef((HD,), F32, ("tp",), "zeros"),
        "hnorm": ParamDef((HD,), F32, ("tp",), "ones"),
    }


def mlstm_state_defs(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    H, Dh = cfg.num_heads, cfg.head_dim
    return {"C": ParamDef((n_layers, batch, H, Dh, Dh), F32,
                          (None, "kv_batch", None, None, "tp"), "zeros"),
            "n": ParamDef((n_layers, batch, H, Dh), F32,
                          (None, "kv_batch", None, "tp"), "zeros"),
            "m": ParamDef((n_layers, batch, H), F32,
                          (None, "kv_batch", None), "zeros"),
            "conv": ParamDef((n_layers, batch, 3, H * Dh), BF16,
                             (None, "kv_batch", None, "tp"), "zeros")}


def _mlstm_chunkwise(q, k, v, li, lf, state, chunk: int = CHUNK):
    """q, k, v [B, S, H, Dh] (k pre-scaled); li, lf [B, S, H] log gates;
    state (C [B, H, Dh, Dh], n [B, H, Dh], m [B, H]) -> (h [B, S, H, Dh]
    f32, state')."""
    B, S, H, Dh = q.shape
    check_length(S, chunk)
    L = min(chunk, S)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    C0, n0, m0 = state
    hs = []
    for c0 in range(0, S, L):
        qb, kb, vb = (t[:, c0:c0 + L].to(F32).transpose(1, 2)
                      for t in (q, k, v))                    # [B, H, L, Dh]
        lib = li[:, c0:c0 + L].transpose(1, 2)               # [B, H, L]
        lfb = lf[:, c0:c0 + L].transpose(1, 2)
        b = torch.cumsum(lfb, dim=-1)
        bL = b[..., -1:]

        # intra-chunk log weights D[j, s] = b_j - b_s + li_s (s <= j)
        Dm = b[..., :, None] - b[..., None, :] + lib[..., None, :]
        Dm = torch.where(causal, Dm, NEG_INF)
        m_intra = torch.amax(Dm, dim=-1)                     # [B, H, L]
        m_inter = m0[..., None] + b
        mj = torch.maximum(m_inter, m_intra)

        Sqk = torch.einsum("bhld,bhsd->bhls", qb, kb)
        w = torch.exp(Dm - mj[..., None])
        num = torch.einsum("bhls,bhsd->bhld", w * Sqk, vb)
        num = num + torch.exp(m_inter - mj)[..., None] * torch.einsum(
            "bhld,bhvd->bhlv", qb, C0)
        den = torch.sum(w * Sqk, dim=-1) + torch.exp(
            m_inter - mj) * torch.einsum("bhld,bhd->bhl", qb, n0)
        h = num / torch.maximum(torch.abs(den), torch.exp(-mj))[..., None]

        # cross-chunk state update
        m_new = torch.maximum(m0 + bL[..., 0],
                              torch.amax(bL - b + lib, dim=-1))  # [B, H]
        wS = torch.exp(bL - b + lib - m_new[..., None])          # [B, H, L]
        C_new = torch.exp(m0 + bL[..., 0] - m_new)[..., None, None] * C0 \
            + torch.einsum("bhs,bhsv,bhsk->bhvk", wS, vb, kb)
        n_new = torch.exp(m0 + bL[..., 0] - m_new)[..., None] * n0 \
            + torch.einsum("bhs,bhsk->bhk", wS, kb)
        C0, n0, m0 = C_new, n_new, m_new
        hs.append(h.transpose(1, 2))                          # [B, L, H, Dh]
    return torch.cat(hs, dim=1), (C0, n0, m0)


def mlstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None, return_state: bool = False):
    """x [B, S, d] -> out [B, S, d] (and the new state): the causal conv
    on the shared q/k source, the gates, the chunkwise (S > 1) or single
    step (S = 1) recurrence, the per-head norm, the output gate and the
    down-projection."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim

    qk_src = x @ p["wq"]                                      # [B, S, HD]
    k_src = x @ p["wk"]
    W = p["conv_w"].shape[0]
    prev_c = (state["conv"] if state is not None else
              torch.zeros((B, W - 1, H * Dh), dtype=x.dtype,
                          device=x.device))
    src = torch.cat([prev_c.to(x.dtype), qk_src + k_src], dim=1)
    conv = sum(src[:, i:i + S, :] * p["conv_w"][i] for i in range(W))
    conv = silu(conv + p["conv_b"].to(x.dtype))
    new_conv = src[:, -(W - 1):, :]

    q = (qk_src + conv).reshape(B, S, H, Dh)
    k = ((k_src + conv) / math.sqrt(Dh)).reshape(B, S, H, Dh)
    v = (x @ p["wv"]).reshape(B, S, H, Dh)
    gates = x.to(F32) @ p["w_if"].to(F32) + p["b_if"]         # [B, S, 2H]
    li = gates[..., :H]                  # input gate (log space, exp)
    lf = F.logsigmoid(gates[..., H:])    # forget gate

    if state is not None:
        st = (state["C"], state["n"], state["m"])
    else:
        st = (torch.zeros((B, H, Dh, Dh), dtype=F32, device=x.device),
              torch.zeros((B, H, Dh), dtype=F32, device=x.device),
              torch.zeros((B, H), dtype=F32, device=x.device))

    if S == 1:  # decode: one recurrence step
        C0, n0, m0 = st
        qs, ks, vs = (t[:, 0].to(F32) for t in (q, k, v))
        lis, lfs = li[:, 0], lf[:, 0]
        m_new = torch.maximum(lfs + m0, lis)
        ip = torch.exp(lis - m_new)
        fp = torch.exp(lfs + m0 - m_new)
        C_new = fp[..., None, None] * C0 + ip[..., None, None] * (
            vs[..., :, None] * ks[..., None, :])
        n_new = fp[..., None] * n0 + ip[..., None] * ks
        num = torch.einsum("bhd,bhvd->bhv", qs, C_new)
        den = torch.einsum("bhd,bhd->bh", qs, n_new)
        h = num / torch.maximum(torch.abs(den),
                                torch.exp(-m_new))[..., None]
        h = h[:, None]                                        # [B, 1, H, Dh]
        st = (C_new, n_new, m_new)
    else:
        h, st = _mlstm_chunkwise(q, k, v, li, lf, st)

    # per-head norm, output gate, down-projection
    hh = h.to(F32)
    var = torch.mean(torch.square(hh), dim=-1, keepdim=True)
    hn = (hh * torch.rsqrt(var + cfg.norm_eps)).reshape(B, S, H * Dh)
    hn = (hn * p["hnorm"]).to(x.dtype)
    z = silu(x @ p["wz"])
    out = shard((hn * z) @ p["wo"], "batch", "sp", None)
    if return_state:
        C_new, n_new, m_new = st
        return out, {"C": C_new, "n": n_new, "m": m_new,
                     "conv": new_conv.to(BF16)}
    return out


# ================================================================ sLSTM


def slstm_defs(cfg: ModelConfig) -> dict:
    """{name: ParamDef} of one sLSTM mixer."""
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    HD = H * Dh
    return {
        "w": ParamDef((d, 4, HD), BF16, ("fsdp", None, "tp"), "scaled"),
        "b": ParamDef((4, HD), F32, (None, "tp"), "zeros"),
        "r": ParamDef((H, Dh, 4, Dh), BF16, (None, None, None, "slstm_r"),
                      "scaled"),
        "hnorm": ParamDef((HD,), F32, ("tp",), "ones"),
        "wo": ParamDef((HD, d), BF16, ("tp", "fsdp"), "scaled"),
    }


def slstm_state_defs(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    shp = (n_layers, batch, cfg.num_heads, cfg.head_dim)
    ax = (None, "kv_batch", None, None)
    return {"c": ParamDef(shp, F32, ax, "zeros"),
            "n": ParamDef(shp, F32, ax, "zeros"),
            "h": ParamDef(shp, F32, ax, "zeros"),
            "m": ParamDef(shp[:-1], F32, ax[:-1], "zeros")}


def slstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None, return_state: bool = False):
    """x [B, S, d] -> out [B, S, d] (and the new state): the input
    projection once, then the h-to-gate recurrence step by step."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim

    wx = torch.einsum("bsd,dgh->bsgh", x.to(F32), p["w"].to(F32))
    wx = (wx + p["b"]).reshape(B, S, 4, H, Dh)

    if state is not None:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    else:
        c = n = h = torch.zeros((B, H, Dh), dtype=F32, device=x.device)
        m = torch.zeros((B, H), dtype=F32, device=x.device)

    r = p["r"].to(F32)
    hs = []
    for t in range(S):
        rg = torch.einsum("bhd,hdgk->bghk", h, r)            # [B, 4, H, Dh]
        g = wx[:, t].transpose(1, 2) + rg.transpose(1, 2)   # [B, H, 4, Dh]
        i_log = g[:, :, 0]
        lf = F.logsigmoid(g[:, :, 1])
        zt = torch.tanh(g[:, :, 2])
        ot = torch.sigmoid(g[:, :, 3])
        # per-head scalar stabilizer (max over the head dim of gate logits)
        m_new = torch.maximum(torch.amax(lf, dim=-1) + m,
                              torch.amax(i_log, dim=-1))
        ip = torch.exp(i_log - m_new[..., None])
        fp = torch.exp(lf + (m - m_new)[..., None])
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1)                              # [B, S, H, Dh]

    var = torch.mean(torch.square(hseq), dim=-1, keepdim=True)
    hn = (hseq * torch.rsqrt(var + cfg.norm_eps)).reshape(B, S, H * Dh)
    out = shard((hn * p["hnorm"]).to(x.dtype) @ p["wo"], "batch", "sp", None)
    if return_state:
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out
