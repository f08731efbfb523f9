"""Model assembly (counterpart of ``repro.models.transformer``) for the
dense family: a stack of identical decoder layers (RMSNorm -> attention
-> residual, RMSNorm -> MLP -> residual), run as a Python loop over the
layers' parameter dicts where the reference scans a stacked tree.

Parameters: ``{"embed": {"table"[, "unembed"]}, "final_norm": {"scale"},
"layers": [layer, ...]}``, each layer ``{"ln1", "attn", "ln2", "ffn"}``
with the reference's names and per-layer layouts (``wq [d, H, Dh]``,
``wo [H, Dh, d]``, ...).  ``convert.lm_params_from_reference`` carries a
reference tree across; ``registry.init_params`` makes a seeded one.

Caches keep the reference's tree and layout: ``{"slot0": {"kv": {"k":
[L, B, T, K, D], "v": ...[, "k_scale", "v_scale"]}}}``, updated in
place and returned.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed, mlp_apply, rmsnorm, unembed

MODES = ("train", "prefill", "decode")
FAMILY_REASON = ("the port runs the dense family only; {family} (experts: "
                 "{experts}) comes with its slice (ROADMAP Queue 1 item 6)")


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str  # attn
    ffn: str = "dense"


def decoder_layout(cfg: ModelConfig) -> tuple[int, list[Slot]]:
    """(n_periods, slots-per-period) of the decoder stack; raises for
    what the port does not run yet."""
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(FAMILY_REASON.format(
            family=cfg.family, experts=cfg.num_experts))
    if cfg.sliding_window:
        raise NotImplementedError(attn.WINDOW_REASON)
    return cfg.num_layers, [Slot("attn", ffn="dense")]


def _apply_slot(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                positions: torch.Tensor, index: int | None,
                kv: dict | None, backend: str) -> torch.Tensor:
    """One decoder layer.  ``kv``: the layer's cache views (prefill and
    decode), written in place."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q = attn.project_q(p["attn"], h, cfg, positions)
    k, v = attn.project_kv(p["attn"], h, cfg, positions)
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
    x = x + attn.project_out(p["attn"], o, cfg)
    hf = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], hf, cfg.act)


def _run_stack(layers: list, x: torch.Tensor, cfg: ModelConfig, *,
               mode: str, positions: torch.Tensor, index: int | None,
               caches: dict | None, backend: str) -> torch.Tensor:
    """The layers in order; layer l reads and writes ``caches``' slice
    l."""
    kv = caches["slot0"]["kv"] if mode != "train" else None
    for l, p in enumerate(layers):
        layer_kv = {name: t[l] for name, t in kv.items()} if kv else None
        x = _apply_slot(p, x, cfg, mode=mode, positions=positions,
                        index=index, kv=layer_kv, backend=backend)
    return x


def forward(params: dict, cfg: ModelConfig, *, tokens: torch.Tensor,
            mode: str = "train", index: int | None = None,
            caches: dict | None = None, logits_slice_last: bool = False,
            backend: str = "cuda"):
    """-> (logits, caches, aux).  ``mode``: train (no cache), prefill
    (writes the cache from slot 0) or decode (one position at ``index``,
    an int).  ``backend``: "cuda" (K7) or "interpret" (plain attention).
    ``aux`` is empty: the dense family has no auxiliary losses."""
    decoder_layout(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in attn.BACKENDS:
        raise KeyError(f"backend must be one of {attn.BACKENDS}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    if mode == "decode":
        index = int(index)
        positions = index + torch.arange(S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    x = _run_stack(params["layers"], x, cfg, mode=mode, positions=positions,
                   index=index, caches=caches, backend=backend)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice_last:
        x = x[:, -1:]
    return unembed(params["embed"], x), caches, {}
