"""Model registry (counterpart of ``repro.models.registry``): parameter
and cache shapes, the parameter count, and seeded initialisation.

``param_defs`` gives, for one layer and for the embedding and final norm,
each tensor's ``common.pytree.ParamDef``: its shape, its reference dtype,
the reference's logical axes for the same tensor (one layer's: the
reference's stacked leaf drops its leading layer axis) and its init kind
(``normal`` x 0.02, ``scaled`` by fan-in: the second-to-last dim, as the
reference's stacked tree has it, ``ones``, ``zeros`` and ``ssm_a``).  An
encdec config adds its encoder's layers and ``enc_norm``; a
cross-attention layer its ``ln_cross`` and ``cross`` (with the scalar
tanh ``gate``, 0 at init, where gated).  ``cache_defs`` and the batch
defs are ParamDef trees too.  ``init_params`` draws them from a
``torch.Generator``; its bits differ from the reference's (the tests
carry the reference's weights across instead).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import pytree as pt
from repro_torch.common.pytree import ParamDef, materialize, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.transformer import decoder_layout, encoder_layout

F32, BF16 = torch.float32, torch.bfloat16


def _attn_defs(cfg: ModelConfig, gated: bool = False) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {"wq": ParamDef((d, H, Dh), BF16, ("fsdp", "tp", None), "scaled"),
            "wk": ParamDef((d, K, Dh), BF16, ("fsdp", "tp", None), "scaled"),
            "wv": ParamDef((d, K, Dh), BF16, ("fsdp", "tp", None), "scaled"),
            "wo": ParamDef((H, Dh, d), BF16, ("tp", None, "fsdp"), "scaled")}
    if cfg.use_qkv_bias:
        defs.update(bq=ParamDef((H, Dh), F32, ("tp", None), "zeros"),
                    bk=ParamDef((K, Dh), F32, ("tp", None), "zeros"),
                    bv=ParamDef((K, Dh), F32, ("tp", None), "zeros"))
    if cfg.use_qk_norm:
        defs.update(q_norm=ParamDef((Dh,), F32, (None,), "ones"),
                    k_norm=ParamDef((Dh,), F32, (None,), "ones"))
    if gated:
        defs["gate"] = ParamDef((), F32, (), "zeros")
    return defs


def _mlp_defs(d: int, d_ff: int, act: str) -> dict:
    if act == "silu":
        return {"wg": ParamDef((d, d_ff), BF16, ("fsdp", "tp"), "scaled"),
                "wu": ParamDef((d, d_ff), BF16, ("fsdp", "tp"), "scaled"),
                "wd": ParamDef((d_ff, d), BF16, ("tp", "fsdp"), "scaled")}
    return {"wi": ParamDef((d, d_ff), BF16, ("fsdp", "tp"), "scaled"),
            "bi": ParamDef((d_ff,), F32, ("tp",), "zeros"),
            "wd": ParamDef((d_ff, d), BF16, ("tp", "fsdp"), "scaled"),
            "bd": ParamDef((d,), F32, (None,), "zeros")}


def _norm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), F32, (None,), "ones")}


def _slot_defs(cfg: ModelConfig, slot, experts) -> dict:
    norm = _norm_defs(cfg.d_model)
    d = {"ln1": dict(norm)}
    if slot.mixer in ("attn", "attn_nc"):
        d["attn"] = _attn_defs(cfg)
    elif slot.mixer == "mamba":
        d["mamba"] = ssm_mod.mamba_defs(cfg)
    elif slot.mixer == "mlstm":
        d["mlstm"] = xlstm_mod.mlstm_defs(cfg)
    else:
        d["slstm"] = xlstm_mod.slstm_defs(cfg)
    if slot.cross:
        d["ln_cross"] = dict(norm)
        d["cross"] = _attn_defs(cfg, gated=slot.gated_cross)
    if slot.ffn != "none":
        d["ln2"] = dict(norm)
        d["ffn"] = (moe_mod.moe_defs(cfg, experts) if slot.ffn == "moe"
                    else _mlp_defs(cfg.d_model, cfg.d_ff, cfg.act))
    return d


def param_defs(cfg: ModelConfig, experts=None) -> dict:
    """{"embed", "final_norm", "slots"[, "encoder_slots", "enc_norm"]} ->
    {name: ParamDef}; "slots" lists one period's layer trees, slot by
    slot (layer l is slot l % P of period l // P), and "encoder_slots" the
    encoder's.  MoE layers hold ``experts`` (None: all)."""
    _, slots = decoder_layout(cfg)
    d = cfg.d_model
    emb = {"table": ParamDef((cfg.vocab_size, d), BF16, ("fsdp", "tp"),
                             "normal")}
    if not cfg.tie_embeddings:
        emb["unembed"] = ParamDef((d, cfg.vocab_size), BF16, ("fsdp", "tp"),
                                  "scaled")
    defs = {"embed": emb, "final_norm": _norm_defs(d),
            "slots": [_slot_defs(cfg, s, experts) for s in slots]}
    if cfg.family == "encdec":
        _, eslots = encoder_layout(cfg)
        defs["encoder_slots"] = [_slot_defs(cfg, s, experts)
                                 for s in eslots]
        defs["enc_norm"] = _norm_defs(d)
    return defs


def layer_defs(cfg: ModelConfig, experts=None) -> dict:
    """``param_defs`` laid out as ``init_params``' tree: "layers" (and
    "encoder") one def tree a layer, slot l % P of each period."""
    defs = param_defs(cfg, experts)

    def stack(n: int, slots: list) -> list:
        return [slots[l % len(slots)] for l in range(n * len(slots))]

    out = {"embed": defs["embed"], "final_norm": defs["final_norm"],
           "layers": stack(decoder_layout(cfg)[0], defs["slots"])}
    if "encoder_slots" in defs:
        out["encoder"] = stack(encoder_layout(cfg)[0],
                               defs["encoder_slots"])
        out["enc_norm"] = defs["enc_norm"]
    return out


def param_count(cfg: ModelConfig) -> int:
    return pt.param_count(layer_defs(cfg))


def _memory_len(cfg: ModelConfig, seq: int) -> int:
    """The cross-attention memory's length: an encdec's frames (as many
    as the sequence), a vlm's image tokens."""
    if cfg.family == "encdec":
        return seq
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return 0


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's ParamDef tree, stacked per slot over the
    periods."""
    n_p, slots = decoder_layout(cfg)
    M = _memory_len(cfg, max_seq)
    out = {}
    for i, s in enumerate(slots):
        if s.mixer == "attn":
            c = {"kv": attn.cache_defs(cfg, batch, max_seq, n_p)}
        elif s.mixer == "mamba":
            c = {"ssm": ssm_mod.mamba_state_defs(cfg, batch, n_p)}
        elif s.mixer == "mlstm":
            c = {"mlstm": xlstm_mod.mlstm_state_defs(cfg, batch, n_p)}
        else:
            c = {"slstm": xlstm_mod.slstm_state_defs(cfg, batch, n_p)}
        if s.cross:
            shape = (n_p, batch, M, cfg.num_kv_heads, cfg.head_dim)
            axes = (None, "kv_batch", None, "tp", None)
            c["cross_kv"] = {"k": ParamDef(shape, BF16, axes, "zeros"),
                             "v": ParamDef(shape, BF16, axes, "zeros")}
        out[f"slot{i}"] = c
    return out


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=BF16, experts=None) -> dict:
    """Seeded parameters on ``device``: tensors of rank >= 2 in ``dtype``,
    scalars, 1-D scales and biases in f32 (the reference's defs' dtypes:
    ``train.cast_for_compute`` casts the per-layer 1-D leaves to bf16 as
    well, as the reference's cast of its stacked tree does); MoE layers
    hold ``experts`` (None: all).  ``generator`` must live on
    ``device``.  The draws follow ``layer_defs``' order: the embedding,
    the final norm, then layer after layer (each layer's keys in their
    defs' order), then the encoder's layers and norm."""
    dev = resolve_device(device)
    defs = tree_map(lambda d: dataclasses.replace(
        d, dtype=dtype if len(d.shape) >= 2 else F32),
        layer_defs(cfg, experts))
    return materialize(defs, generator, dev)


def _stacks(cfg: ModelConfig) -> list:
    """(per-layer defs tree, layers stacked) of the embedding and final
    norm (1), each decoder slot (its periods) and each encoder slot."""
    n_p, _ = decoder_layout(cfg)
    defs = param_defs(cfg)
    out = [(defs["embed"], 1), (defs["final_norm"], 1)]
    out += [(t, n_p) for t in defs["slots"]]
    if "encoder_slots" in defs:
        n_e, _ = encoder_layout(cfg)
        out += [(defs["enc_norm"], 1)]
        out += [(t, n_e) for t in defs["encoder_slots"]]
    return out


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: the reference's count over its
    scan-stacked leaves, where an FFN leaf of stacked rank >= 3 (per layer
    >= 2), other than the router, counts k/E of its size (truncated per
    stacked leaf) in a config with experts."""
    total = 0

    def walk(t, n_stack, in_ffn):
        nonlocal total
        for name, v in t.items():
            if isinstance(v, dict):
                walk(v, n_stack, in_ffn or name == "ffn")
                continue
            shape = v.shape
            n = n_stack * v.size
            if in_ffn and cfg.num_experts and len(shape) >= 2 \
                    and name != "router":
                n = int(n * cfg.num_experts_per_tok / cfg.num_experts)
            total += n

    for tree, n_stack in _stacks(cfg):
        walk(tree, n_stack, False)
    return total


def model_flops(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS = 6 * N_active * tokens (train) or 2 * N_active *
    tokens (prefill; decode one token a sequence): the reference's
    roofline convention.  ``shape`` a ``configs.base.ShapeConfig``."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def train_batch_defs(cfg: ModelConfig, shape) -> dict:
    """{name: ParamDef} of a training batch: ``tokens`` and ``targets``
    [B, S] int32; an encdec's ``frames`` [B, S, d] and a vlm's
    ``image_embeds`` [B, num_image_tokens, d], bf16."""
    B, S = shape.global_batch, shape.seq_len
    ids = ParamDef((B, S), torch.int32, ("batch", None), "zeros")
    d = {"tokens": ids, "targets": ids}
    if cfg.family == "encdec":
        d["frames"] = ParamDef((B, S, cfg.d_model), BF16,
                               ("batch", None, None), "normal")
    if cfg.family == "vlm":
        d["image_embeds"] = ParamDef((B, cfg.num_image_tokens, cfg.d_model),
                                     BF16, ("batch", None, None), "normal")
    return d


def prefill_batch_defs(cfg: ModelConfig, shape) -> dict:
    d = train_batch_defs(cfg, shape)
    d.pop("targets")
    return d


def decode_batch_defs(cfg: ModelConfig, shape) -> dict:
    return {"tokens": ParamDef((shape.global_batch, 1), torch.int32,
                               ("batch", None), "zeros")}
