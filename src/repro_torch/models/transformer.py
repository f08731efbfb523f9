"""Model assembly (counterpart of ``repro.models.transformer``):
``n_periods`` identical periods of slots, each slot a mixer (attention,
Mamba, mLSTM or sLSTM), an optional cross-attention and an FFN (dense
MLP, MoE or none), run as a Python loop over the layers' parameter
dicts where the reference scans a stacked tree per slot.

  dense   period = 1 layer [attn + dense]              x num_layers
  moe     period = 1 layer [attn + MoE]                x num_layers
          (and a dense-family config with num_experts > 0)
  hybrid  period = [mamba*, attn at P // 2, mamba*]    x num_layers / P
          (P = attn_period; MoE FFN where i % moe_period == moe_offset)
  ssm     period = [sLSTM, mLSTM x (P - 1)], no FFN    x num_layers / P
  vlm     period = [attn + gated cross-attn, attn x (P - 1)]
                                                       x num_layers / P
  encdec  an encoder of num_encoder_layers [non-causal attn + dense],
          then num_decoder_layers [attn + cross-attn + dense]

Parameters: ``{"embed": {"table"[, "unembed"]}, "final_norm": {"scale"},
"layers": [layer, ...]}`` (and for encdec ``"encoder": [layer, ...]``
and ``"enc_norm"``), layer l = p * P + i being slot i of period p:
``{"ln1", "attn" | "mamba" | "mlstm" | "slstm"[, "ln_cross", "cross"][,
"ln2", "ffn"]}`` with the reference's names and per-layer layouts
(``wq [d, H, Dh]``, ``in_proj [d, 2 di]``, an MoE ``ffn`` ``{"router"
[d, E], "wg" [E_held, d, ff], ...}``, a gated ``cross`` with its scalar
``gate``).  ``convert.lm_params_from_reference`` carries a reference
tree across; ``registry.init_params`` makes a seeded one.

Caches keep the reference's tree and layout, stacked per slot over the
periods: ``{"slot{i}": {"kv": {"k": [n_p, B, T, K, D], ...}}}`` for an
attention slot, ``"ssm"`` (Mamba: ``h``, ``conv``), ``"mlstm"`` (``C``,
``n``, ``m``, ``conv``) or ``"slstm"`` (``c``, ``n``, ``h``, ``m``) for
a recurrent one, and ``"cross_kv"`` (``k``, ``v`` [n_p, B, M, K, D]
bf16) beside a cross-attention; updated in place and returned.  Two
leaves are replaced instead, as the reference's are: a Mamba slot's
conv state takes the activations' dtype, and a prefill's cross-attention
keys and values take the memory's length M.  That length is the
registry's for a vlm (``num_image_tokens``), so its leaf stays; an
encdec's memory is the round's frames, so its leaf takes each prefill's
M, and decode then attends every key of it.  The leaf, not a length
carried beside a buffer, keeps the cache tree the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import assign, is_dtensor, replicate_plain, shard
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import embed, mlp_apply, rmsnorm, unembed

MODES = ("train", "prefill", "decode")
MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


@dataclasses.dataclass(frozen=True)
class Slot:
    """A layer's kind: ``mixer`` attn | attn_nc (non-causal) | mamba |
    mlstm | slstm; ``ffn`` dense | moe | none; ``cross``: a cross-
    attention after the mixer (``gated_cross``: with a tanh gate)."""
    mixer: str
    ffn: str = "dense"
    cross: bool = False
    gated_cross: bool = False


def _periods(cfg: ModelConfig, P: int) -> int:
    if P < 1 or cfg.num_layers % P:
        raise ValueError(f"num_layers={cfg.num_layers} is not a whole "
                         f"number of {P}-layer periods")
    return cfg.num_layers // P


def decoder_layout(cfg: ModelConfig) -> tuple[int, list[Slot]]:
    """(n_periods, slots-per-period) of the decoder stack."""
    fam = cfg.family
    if fam in ("dense", "moe"):
        return cfg.num_layers, [Slot("attn", ffn="moe" if cfg.num_experts
                                     else "dense")]
    if fam == "hybrid":
        P = cfg.attn_period
        n_p = _periods(cfg, P)
        return n_p, [Slot("attn" if i == P // 2 else "mamba",
                          ffn="moe" if i % cfg.moe_period == cfg.moe_offset
                          else "dense") for i in range(P)]
    if fam == "ssm":
        P = cfg.slstm_period
        n_p = _periods(cfg, P)
        return n_p, [Slot("slstm" if i == 0 else "mlstm", ffn="none")
                     for i in range(P)]
    if fam == "vlm":
        P = cfg.cross_attn_period
        n_p = _periods(cfg, P)
        return n_p, [Slot("attn", cross=i == 0, gated_cross=True)
                     for i in range(P)]
    if fam == "encdec":
        return cfg.num_decoder_layers, [Slot("attn", cross=True)]
    raise ValueError(fam)


def encoder_layout(cfg: ModelConfig) -> tuple[int, list[Slot]]:
    """(n_layers, [slot]) of an encdec config's encoder stack."""
    return cfg.num_encoder_layers, [Slot("attn_nc")]


def _attention(p: dict, h: torch.Tensor, cfg: ModelConfig, *, mode: str,
               positions: torch.Tensor, index: int | None, kv: dict | None,
               backend: str, causal: bool = True) -> torch.Tensor:
    """An attention mixer (``causal=False``: the encoder's).  ``kv``: the
    layer's cache views (prefill and decode), written in place.  Prefill
    writes the last T keys to slots 0..T-1, as the reference does, so
    with a window and S > T the first decode step writes slot S % T,
    which then holds position S - T + S % T, not the oldest."""
    window = cfg.sliding_window
    q = attn.project_q(p, h, cfg, positions)
    k, v = attn.project_kv(p, h, cfg, positions)
    if mode == "decode":
        attn.cache_update_tree(kv, k, v, index, window=window)
        o = attn.decode_attention_tree(q, kv, index, backend=backend,
                                       window=window)
    else:
        o = attn.prefill_attention(q, k, v, backend=backend, causal=causal,
                                   window=window)
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
    assign(st["h"], new["h"])
    assign(st["conv"], new["conv"])
    return out


def _recurrent(apply, p: dict, h: torch.Tensor, cfg: ModelConfig, *,
               mode: str, st: dict | None) -> torch.Tensor:
    """An mLSTM or sLSTM mixer (``apply``): prefill from a zero state,
    decode from the carried one; the new state is written over ``st``'s
    views."""
    if mode == "train":
        return apply(p, h, cfg)
    out, new = apply(p, h, cfg, state=st if mode == "decode" else None,
                     return_state=True)
    for name, t in new.items():
        assign(st[name], t)
    return out


def _cross(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
           ckv: dict | None, memory: torch.Tensor | None,
           backend: str) -> torch.Tensor:
    """A cross-attention over the memory: no RoPE, non-causal over every
    key.  Train and prefill project the memory (prefill also writes its
    keys and values, bf16, into ``ckv``'s views); decode reads them from
    ``ckv``."""
    hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
    qc = attn.project_q(p["cross"], hc, cfg)
    if mode == "decode":
        ck, cv = ckv["k"], ckv["v"]
    else:
        ck, cv = attn.project_kv(p["cross"], memory, cfg)
        if mode == "prefill":
            assign(ckv["k"], ck)
            assign(ckv["v"], cv)
    oc = attn.prefill_attention(qc, ck, cv, backend=backend, causal=False)
    return attn.project_out(p["cross"], oc, cfg)


def _apply_slot(p: dict, slot: Slot, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, positions: torch.Tensor, index: int | None,
                cache: dict | None, backend: str, experts,
                memory: torch.Tensor | None = None):
    """One layer -> (x, aux)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if slot.mixer in ("attn", "attn_nc"):
        out = _attention(p["attn"], h, cfg, mode=mode, positions=positions,
                         index=index, kv=cache and cache["kv"],
                         backend=backend, causal=slot.mixer == "attn")
    elif slot.mixer == "mamba":
        out = _mamba(p["mamba"], h, cfg, mode=mode,
                     st=cache and cache["ssm"], backend=backend)
    elif slot.mixer == "mlstm":
        out = _recurrent(xlstm_mod.mlstm_apply, p["mlstm"], h, cfg,
                         mode=mode, st=cache and cache["mlstm"])
    elif slot.mixer == "slstm":
        out = _recurrent(xlstm_mod.slstm_apply, p["slstm"], h, cfg,
                         mode=mode, st=cache and cache["slstm"])
    else:
        raise ValueError(slot.mixer)
    x = shard(x + out, "batch", "sp", None)
    if slot.cross:
        x = x + _cross(p, x, cfg, mode=mode, ckv=cache and cache["cross_kv"],
                       memory=memory, backend=backend)
        x = shard(x, "batch", "sp", None)
    if slot.ffn == "none":
        return x, {}
    hf = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if slot.ffn == "moe":
        out, aux = moe_mod.moe_apply(p["ffn"], hf, cfg, experts=experts)
    else:
        out, aux = mlp_apply(p["ffn"], hf, cfg.act), {}
    return shard(x + out, "batch", "sp", None), aux


def _period_view(slot_cache: dict, period: int) -> dict:
    return {kind: {name: t[period] for name, t in leaves.items()}
            for kind, leaves in slot_cache.items()}


def _replace_leaves(caches: dict, slots: list[Slot], n_p: int,
                    x: torch.Tensor, memory: torch.Tensor | None,
                    mode: str) -> None:
    """The leaves the reference replaces: a Mamba conv state in x's
    dtype; in prefill, cross-attention keys and values [n_p, B, M, K, D]
    of the memory's length M (bf16)."""
    for i, slot in enumerate(slots):
        c = caches[f"slot{i}"]
        ssm = c.get("ssm")
        if ssm is not None and ssm["conv"].dtype != x.dtype:
            ssm["conv"] = ssm["conv"].to(x.dtype)
        if slot.cross and mode == "prefill":
            B, M = memory.shape[0], memory.shape[1]
            ckv = c["cross_kv"]
            shape = (n_p, B, M) + tuple(ckv["k"].shape[3:])
            if tuple(ckv["k"].shape) != shape:
                c["cross_kv"] = {n: _zeros_like_leaf(t, shape)
                                 for n, t in ckv.items()}


def _zeros_like_leaf(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A zero cross-attention leaf of ``shape`` in ``t``'s dtype, on
    ``t``'s device; under a mesh placed by the cache's axes (the
    reference's ``cross_kv`` defs)."""
    if is_dtensor(t):
        local = torch.zeros(shape, dtype=t.dtype,
                            device=t.to_local().device)
        return shard(local, None, "kv_batch", None, "tp", None)
    return torch.zeros(shape, dtype=t.dtype, device=t.device)


def _remat_kwargs(policy: str) -> dict:
    """``torch.utils.checkpoint``'s extra arguments for a remat policy:
    "block" recomputes the whole period; "dots" keeps the outputs of the
    2-D products (``aten.mm``, ``aten.addmm``: every projection, which
    has no batch dim once its input is flattened) and recomputes the
    rest, the counterpart of ``checkpoint_dots_with_no_batch_dims``."""
    if policy == "block":
        return {}
    if policy == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        aten = torch.ops.aten
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts,
            [aten.mm.default, aten.addmm.default])}
    raise ValueError(f"remat_policy {policy!r}: one of none, block, dots")


def _run_stack(layers: list, slots: list[Slot], x: torch.Tensor,
               cfg: ModelConfig, *, mode: str, positions: torch.Tensor,
               index: int | None, caches: dict | None, backend: str,
               experts, memory: torch.Tensor | None = None,
               remat: bool = False):
    """Periods x slots in order (layer p * P + i); slot i of period p
    reads and writes ``caches["slot{i}"]``' slice p.  -> (x, aux summed
    over the periods, each period's in slot order).  ``remat`` in train
    mode: each period runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward, as the reference's
    ``jax.checkpoint`` of the period), all of them for
    ``cfg.remat_policy == "block"``, all but the 2-D products' outputs
    for ``"dots"``."""
    P = len(slots)
    aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
            for k in MOE_AUX} if any(s.ffn == "moe" for s in slots) else {})
    if mode != "train":
        _replace_leaves(caches, slots, len(layers) // P, x, memory, mode)

    def period_fn(x, period: int, memory):
        per = {}
        for i, slot in enumerate(slots):
            cache = (None if mode == "train"
                     else _period_view(caches[f"slot{i}"], period))
            x, a = _apply_slot(layers[period * P + i], slot, x, cfg,
                               mode=mode, positions=positions, index=index,
                               cache=cache, backend=backend, experts=experts,
                               memory=memory)
            if a:
                per = a if not per else {k: per[k] + a[k] for k in per}
        return x, per

    remat = remat and mode == "train" and cfg.remat_policy != "none"
    remat_kw = _remat_kwargs(cfg.remat_policy) if remat else {}
    for period in range(len(layers) // P):
        if remat:
            x, per = torch.utils.checkpoint.checkpoint(
                period_fn, x, period, memory, use_reentrant=False,
                preserve_rng_state=False, **remat_kw)
        else:
            x, per = period_fn(x, period, memory)
        if per:
            aux = {k: aux[k] + per[k] for k in aux}
    return x, aux


def check_lengths(cfg: ModelConfig, batch: int, seq: int) -> None:
    """Raises for a [batch, seq] input the reference's layers refuse:
    the Mamba scan's and the mLSTM's chunk rules and the MoE grouping
    rule."""
    _, slots = decoder_layout(cfg)
    if any(s.mixer == "mamba" for s in slots):
        ssm_mod.check_length(seq)
    if any(s.mixer == "mlstm" for s in slots):
        xlstm_mod.check_length(seq)
    if any(s.ffn == "moe" for s in slots):
        moe_mod.check_tokens(batch * seq)


def forward(params: dict, cfg: ModelConfig, *,
            tokens: torch.Tensor | None = None,
            inputs_embeds: torch.Tensor | None = None,
            memory_embeds: torch.Tensor | None = None,
            mode: str = "train", index: int | None = None,
            caches: dict | None = None, logits_slice_last: bool = False,
            backend: str = "cuda", experts=None, remat: bool = False):
    """-> (logits, caches, aux).  ``tokens`` [B, S] (or ``inputs_embeds``
    [B, S, d]); ``memory_embeds`` [B, M, d]: an encdec's frames (the
    encoder runs over them, positions arange(M)) or a vlm's image
    embeddings, both cast to the weights' dtype, read in train and
    prefill.  ``mode``: train (no cache), prefill (writes the cache from
    slot 0 / a zero state) or decode (one position at ``index``, an
    int).  ``backend``: "cuda" (K7, K8) or "interpret" (the plain
    versions).  ``experts``: the expert ids the MoE layers hold (None:
    all).  ``aux``: the MoE aux values summed over the layers, empty
    without MoE.  ``remat``: in train mode, recompute each period's
    activations in the backward (``cfg.remat_policy``; see
    ``_run_stack``)."""
    with replicate_plain():
        return _forward(params, cfg, tokens=tokens,
                        inputs_embeds=inputs_embeds,
                        memory_embeds=memory_embeds, mode=mode, index=index,
                        caches=caches, logits_slice_last=logits_slice_last,
                        backend=backend, experts=experts, remat=remat)


def _forward(params: dict, cfg: ModelConfig, *, tokens, inputs_embeds,
             memory_embeds, mode: str, index, caches, logits_slice_last: bool,
             backend: str, experts, remat: bool):
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
    wdtype = params["embed"]["table"].dtype
    if inputs_embeds is None:
        x = embed(params["embed"], tokens)
    else:
        x = inputs_embeds.to(wdtype)
    if memory_embeds is not None:
        memory_embeds = memory_embeds.to(wdtype)
    check_lengths(cfg, *x.shape[:2])
    S = x.shape[1]
    if mode == "decode":
        index = int(index)
        positions = index + torch.arange(S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    if cfg.family in ("encdec", "vlm") and mode != "decode" \
            and memory_embeds is None:
        raise ValueError(f"a {cfg.family} forward in mode {mode!r} needs "
                         "memory_embeds")
    memory = None
    if cfg.family == "encdec" and mode != "decode":
        _, eslots = encoder_layout(cfg)
        epos = torch.arange(memory_embeds.shape[1], device=x.device)
        menc, _ = _run_stack(params["encoder"], eslots, memory_embeds, cfg,
                             mode="train", positions=epos, index=None,
                             caches=None, backend=backend, experts=experts,
                             remat=remat)
        memory = rmsnorm(params["enc_norm"], menc, cfg.norm_eps)
    elif cfg.family == "vlm":
        memory = memory_embeds
    x, aux = _run_stack(params["layers"], slots, x, cfg, mode=mode,
                        positions=positions, index=index, caches=caches,
                        backend=backend, experts=experts, memory=memory,
                        remat=remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice_last:
        x = x[:, -1:]
    return unembed(params["embed"], x), caches, aux
