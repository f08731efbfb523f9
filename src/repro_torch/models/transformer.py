"""Model assembly (counterpart of ``repro.models.transformer``) for the
dense, MoE and hybrid families: ``n_periods`` identical periods of
slots, each slot a mixer (attention or Mamba) and an FFN (dense MLP or
MoE), run as a Python loop over the layers' parameter dicts where the
reference scans a stacked tree per slot.

  dense   period = 1 layer [attn + dense]              x num_layers
  moe     period = 1 layer [attn + MoE]                x num_layers
          (and a dense-family config with num_experts > 0)
  hybrid  period = [mamba*, attn at P // 2, mamba*]    x num_layers / P
          (P = attn_period; MoE FFN where i % moe_period == moe_offset)

Parameters: ``{"embed": {"table"[, "unembed"]}, "final_norm": {"scale"},
"layers": [layer, ...]}``, layer l = p * P + i being slot i of period p:
``{"ln1", "attn" | "mamba", "ln2", "ffn"}`` with the reference's names
and per-layer layouts (``wq [d, H, Dh]``, ``in_proj [d, 2 di]``, an MoE
``ffn`` ``{"router" [d, E], "wg" [E_held, d, ff], ...}``).
``convert.lm_params_from_reference`` carries a reference tree across;
``registry.init_params`` makes a seeded one.

Caches keep the reference's tree and layout, stacked per slot over the
periods: ``{"slot{i}": {"kv": {"k": [n_p, B, T, K, D], ...}}}`` for an
attention slot and ``{"slot{i}": {"ssm": {"h": [n_p, B, di, N], "conv":
[n_p, B, W-1, di]}}}`` for a Mamba slot, updated in place and returned.
As in the reference, a Mamba slot's conv state takes the activations'
dtype (the leaf is replaced when it differs).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import embed, mlp_apply, rmsnorm, unembed

MODES = ("train", "prefill", "decode")
FAMILY_REASON = ("the port runs the dense, MoE and hybrid families; {family} "
                 "(experts: {experts}) comes with its slice (ROADMAP Queue 1 "
                 "item 6)")
MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str          # attn | mamba
    ffn: str = "dense"  # dense | moe


def decoder_layout(cfg: ModelConfig) -> tuple[int, list[Slot]]:
    """(n_periods, slots-per-period) of the decoder stack; raises for
    what the port does not run yet."""
    if cfg.sliding_window:
        raise NotImplementedError(attn.WINDOW_REASON)
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers, [Slot("attn", ffn="moe" if cfg.num_experts
                                     else "dense")]
    if cfg.family == "hybrid":
        P = cfg.attn_period
        if P < 1 or cfg.num_layers % P:
            raise ValueError(f"num_layers={cfg.num_layers} is not a whole "
                             f"number of {P}-layer periods")
        slots = [Slot("attn" if i == P // 2 else "mamba",
                      ffn="moe" if i % cfg.moe_period == cfg.moe_offset
                      else "dense") for i in range(P)]
        return cfg.num_layers // P, slots
    raise NotImplementedError(FAMILY_REASON.format(
        family=cfg.family, experts=cfg.num_experts))


def _attention(p: dict, h: torch.Tensor, cfg: ModelConfig, *, mode: str,
               positions: torch.Tensor, index: int | None, kv: dict | None,
               backend: str) -> torch.Tensor:
    """An attention mixer.  ``kv``: the layer's cache views (prefill and
    decode), written in place."""
    q = attn.project_q(p, h, cfg, positions)
    k, v = attn.project_kv(p, h, cfg, positions)
    if mode == "decode":
        attn.cache_update_tree(kv, k, v, index)
        o = attn.decode_attention_tree(q, kv, index, backend=backend)
    else:
        o = attn.prefill_attention(q, k, v, backend=backend)
        if mode == "prefill":
            T = kv["k"].shape[1]
            kw = k[:, -T:] if k.shape[1] > T else k
            vw = v[:, -T:] if v.shape[1] > T else v
            attn.cache_update_tree(kv, kw, vw, 0)
    return attn.project_out(p, o, cfg)


def _mamba(p: dict, h: torch.Tensor, cfg: ModelConfig, *, mode: str,
           st: dict | None, backend: str) -> torch.Tensor:
    """A Mamba mixer: prefill from a zero state, decode from the carried
    one; the new state is written over ``st``'s views."""
    if mode == "train":
        return ssm_mod.mamba_apply(p, h, cfg, backend=backend)
    out, new = ssm_mod.mamba_apply(
        p, h, cfg, state=st if mode == "decode" else None,
        return_state=True, backend=backend)
    st["h"].copy_(new["h"])
    st["conv"].copy_(new["conv"])
    return out


def _apply_slot(p: dict, slot: Slot, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, positions: torch.Tensor, index: int | None,
                cache: dict | None, backend: str, experts):
    """One decoder layer -> (x, aux)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if slot.mixer == "attn":
        out = _attention(p["attn"], h, cfg, mode=mode, positions=positions,
                         index=index, kv=cache and cache["kv"],
                         backend=backend)
    else:
        out = _mamba(p["mamba"], h, cfg, mode=mode,
                     st=cache and cache["ssm"], backend=backend)
    x = x + out
    hf = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if slot.ffn == "moe":
        out, aux = moe_mod.moe_apply(p["ffn"], hf, cfg, experts=experts)
    else:
        out, aux = mlp_apply(p["ffn"], hf, cfg.act), {}
    return x + out, aux


def _period_view(slot_cache: dict, period: int) -> dict:
    return {kind: {name: t[period] for name, t in leaves.items()}
            for kind, leaves in slot_cache.items()}


def _run_stack(layers: list, slots: list[Slot], x: torch.Tensor,
               cfg: ModelConfig, *, mode: str, positions: torch.Tensor,
               index: int | None, caches: dict | None, backend: str,
               experts):
    """Periods x slots in order (layer p * P + i); slot i of period p
    reads and writes ``caches["slot{i}"]``' slice p.  -> (x, aux summed
    over the periods, each period's in slot order)."""
    P = len(slots)
    aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
            for k in MOE_AUX} if any(s.ffn == "moe" for s in slots) else {})
    if mode != "train":
        for i in range(P):
            ssm = caches[f"slot{i}"].get("ssm")
            if ssm is not None and ssm["conv"].dtype != x.dtype:
                ssm["conv"] = ssm["conv"].to(x.dtype)
    for period in range(len(layers) // P):
        per = None
        for i, slot in enumerate(slots):
            cache = (None if mode == "train"
                     else _period_view(caches[f"slot{i}"], period))
            x, a = _apply_slot(layers[period * P + i], slot, x, cfg,
                               mode=mode, positions=positions, index=index,
                               cache=cache, backend=backend, experts=experts)
            if a:
                per = a if per is None else {k: per[k] + a[k] for k in per}
        if per:
            aux = {k: aux[k] + per[k] for k in aux}
    return x, aux


def check_lengths(cfg: ModelConfig, batch: int, seq: int) -> None:
    """Raises for a [batch, seq] input the reference's layers refuse:
    the Mamba scan's chunk rule and the MoE grouping rule."""
    _, slots = decoder_layout(cfg)
    if any(s.mixer == "mamba" for s in slots):
        ssm_mod.check_length(seq)
    if any(s.ffn == "moe" for s in slots):
        moe_mod.check_tokens(batch * seq)


def forward(params: dict, cfg: ModelConfig, *, tokens: torch.Tensor,
            mode: str = "train", index: int | None = None,
            caches: dict | None = None, logits_slice_last: bool = False,
            backend: str = "cuda", experts=None):
    """-> (logits, caches, aux).  ``mode``: train (no cache), prefill
    (writes the cache from slot 0 / a zero state) or decode (one
    position at ``index``, an int).  ``backend``: "cuda" (K7, K8) or
    "interpret" (the plain versions).  ``experts``: the expert ids the
    MoE layers hold (None: all).  ``aux``: the MoE aux values summed
    over the layers, empty without MoE."""
    n_p, slots = decoder_layout(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in attn.BACKENDS:
        raise KeyError(f"backend must be one of {attn.BACKENDS}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if len(params["layers"]) != n_p * len(slots):
        raise ValueError(f"{len(params['layers'])} layers for "
                         f"{n_p} x {len(slots)}")
    check_lengths(cfg, *tokens.shape)
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    if mode == "decode":
        index = int(index)
        positions = index + torch.arange(S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    x, aux = _run_stack(params["layers"], slots, x, cfg, mode=mode,
                        positions=positions, index=index, caches=caches,
                        backend=backend, experts=experts)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice_last:
        x = x[:, -1:]
    return unembed(params["embed"], x), caches, aux
