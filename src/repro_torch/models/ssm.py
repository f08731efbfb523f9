"""Mamba (S6) selective-state-space block (counterpart of
``repro.models.ssm``): input projection, depthwise causal conv, the
discretized selective scan, the gated RMS-normed output.  Prefill runs
the scan over the whole sequence from a zero state; decode is the same
scan at S = 1 from the carried (h, conv) state.

Two scan engines, chosen by ``backend``:

  * ``"cuda"``: K8's discretizing entry (``kernels.selective_scan.
    selective_scan_discretized``) for prefill and for every decode step
    (S = 1): it forms dA = exp(dt A) and dBx = dt B x in registers, so no
    [B, S, di, N] tensor is allocated.  On CPU tensors its plain version
    runs (the eager discretization, then the sequential recurrence).
  * ``"interpret"``: the eager discretization and the plain sequential
    recurrence on any device.

The reference serves a sequence through ``_ssm_scan_chunked``, an
associative scan over chunks of ``min(256, S)`` steps, which refuses an
S the chunk does not divide; ``check_length`` refuses the same lengths.
Its sums run in another order than the sequential recurrence, so the
block matches it within tolerance, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.pytree import ParamDef
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import (
    selective_scan_discretized,
    selective_scan_discretized_ref,
)
from repro_torch.models.attention import BACKENDS
from repro_torch.models.layers import silu

F32, BF16 = torch.float32, torch.bfloat16
SCAN_CHUNK = 256   # the reference's chunk (repro/models/ssm.py:63)


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def mamba_defs(cfg: ModelConfig) -> dict:
    """{name: ParamDef} of one Mamba mixer."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_d_state
    R = dt_rank(cfg)
    return {
        "in_proj": ParamDef((d, 2 * di), BF16, ("fsdp", "tp"), "scaled"),
        "conv_w": ParamDef((cfg.ssm_d_conv, di), BF16, (None, "tp"),
                           "scaled"),
        "conv_b": ParamDef((di,), F32, ("tp",), "zeros"),
        "x_proj": ParamDef((di, R + 2 * N), BF16, ("tp", None), "scaled"),
        "dt_proj": ParamDef((R, di), BF16, (None, "tp"), "scaled"),
        "dt_bias": ParamDef((di,), F32, ("tp",), "zeros"),
        "A_log": ParamDef((di, N), F32, ("tp", None), "ssm_a"),
        "D": ParamDef((di,), F32, ("tp",), "ones"),
        "norm": ParamDef((di,), F32, ("tp",), "ones"),
        "out_proj": ParamDef((di, d), BF16, ("tp", "fsdp"), "scaled"),
    }


def mamba_state_defs(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    """{name: ParamDef} of the stacked decode state."""
    di, N, W = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    return {"h": ParamDef((n_layers, batch, di, N), F32,
                          (None, "kv_batch", "tp", None), "zeros"),
            "conv": ParamDef((n_layers, batch, W - 1, di), BF16,
                             (None, "kv_batch", None, "tp"), "zeros")}


def check_length(S: int) -> None:
    """Raises for a sequence length the reference's chunked scan
    refuses."""
    chunk = min(SCAN_CHUNK, S)
    if chunk and S % chunk:
        raise ValueError(
            f"a Mamba block over S={S} positions: the reference's chunked "
            f"scan takes chunks of min({SCAN_CHUNK}, S) = {chunk} steps and "
            "refuses an S they do not divide")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None):
    """Depthwise causal conv1d.  x [B, S, di]; w [W, di]; prev [B, W-1,
    di] -> (out [B, S, di], the last W-1 inputs as the new prev), summed
    in x's dtype in the reference's order."""
    W = w.shape[0]
    B, S, di = x.shape
    if prev is None:
        prev = torch.zeros((B, W - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b.to(x.dtype)
    new_prev = xp[:, -(W - 1):] if W > 1 else prev
    return out, new_prev


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None, return_state: bool = False,
                backend: str = "cuda"):
    """x [B, S, d] -> out [B, S, d] (and, with ``return_state``, the new
    {"h": [B, di, N] f32, "conv": [B, W-1, di] in x's dtype}).  ``state``
    is the carried state (decode), None for a zero one (prefill)."""
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_d_state
    R = dt_rank(cfg)
    if backend not in BACKENDS:
        raise KeyError(f"backend must be one of {BACKENDS}")
    check_length(S)

    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    prev = state["conv"] if state is not None else None
    xin, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], prev)
    xin = silu(xin)

    proj = (xin @ p["x_proj"]).to(F32)           # [B, S, R + 2N]
    dt, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = _softplus(dt @ p["dt_proj"].to(F32) + p["dt_bias"])   # [B, S, di]
    # [di, N] in A_log's dtype, widened exactly: dt * A is f32 either way
    A = (-torch.exp(p["A_log"])).to(F32)
    h0 = (state["h"] if state is not None
          else torch.zeros((B, di, N), dtype=F32, device=x.device))
    # the eager path builds dA and dBx, [B, S, di, N] f32 (2.15 GB each at
    # the Jamba width with B = 4 and S = 512); K8 forms them in registers
    scan = (selective_scan_discretized if backend == "cuda"
            else selective_scan_discretized_ref)
    y, h_final = scan(dt, A.contiguous(), Bm.contiguous(), Cm.contiguous(),
                      xin, h0.contiguous())

    y = y + p["D"] * xin.to(F32)
    y = y.to(x.dtype) * silu(z)
    # jamba-style RMS norm on the gated output
    var = torch.mean(torch.square(y.to(F32)), dim=-1, keepdim=True)
    y = (y.to(F32) * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"h": h_final, "conv": conv_state}
    return out
