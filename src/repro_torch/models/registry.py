"""Model registry (counterpart of ``repro.models.registry``): parameter
and cache shapes, the parameter count, and seeded initialisation.

``param_defs`` gives, for one layer and for the embedding and final norm,
each tensor's shape, its reference dtype and its init kind — the
``ParamDef`` kinds of ``repro.common.pytree``: ``normal`` (x 0.02),
``scaled`` (by fan-in: the second-to-last dim, as the reference's stacked
tree has it), ``ones``, ``zeros`` and ``ssm_a`` (Mamba's ``A_log``:
log(1..N) in every channel).  An encdec config adds its encoder's
layers and ``enc_norm``; a cross-attention layer its ``ln_cross`` and
``cross`` (with the scalar tanh ``gate``, 0 at init, where gated).
``init_params`` draws them from a ``torch.Generator``; its bits differ
from the reference's (the tests carry the reference's weights across
instead).
"""

from __future__ import annotations

import math

import torch

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
    defs = {"wq": ((d, H, Dh), BF16, "scaled"),
            "wk": ((d, K, Dh), BF16, "scaled"),
            "wv": ((d, K, Dh), BF16, "scaled"),
            "wo": ((H, Dh, d), BF16, "scaled")}
    if cfg.use_qkv_bias:
        defs.update(bq=((H, Dh), F32, "zeros"), bk=((K, Dh), F32, "zeros"),
                    bv=((K, Dh), F32, "zeros"))
    if cfg.use_qk_norm:
        defs.update(q_norm=((Dh,), F32, "ones"), k_norm=((Dh,), F32, "ones"))
    if gated:
        defs["gate"] = ((), F32, "zeros")
    return defs


def _mlp_defs(d: int, d_ff: int, act: str) -> dict:
    if act == "silu":
        return {"wg": ((d, d_ff), BF16, "scaled"),
                "wu": ((d, d_ff), BF16, "scaled"),
                "wd": ((d_ff, d), BF16, "scaled")}
    return {"wi": ((d, d_ff), BF16, "scaled"), "bi": ((d_ff,), F32, "zeros"),
            "wd": ((d_ff, d), BF16, "scaled"), "bd": ((d,), F32, "zeros")}


def _slot_defs(cfg: ModelConfig, slot, experts) -> dict:
    norm = {"scale": ((cfg.d_model,), F32, "ones")}
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
    {name: (shape, dtype, init)}; "slots" lists one period's layer
    trees, slot by slot (layer l is slot l % P of period l // P), and
    "encoder_slots" the encoder's.  MoE layers hold ``experts`` (None:
    all)."""
    _, slots = decoder_layout(cfg)
    d = cfg.d_model
    emb = {"table": ((cfg.vocab_size, d), BF16, "normal")}
    if not cfg.tie_embeddings:
        emb["unembed"] = ((d, cfg.vocab_size), BF16, "scaled")
    defs = {"embed": emb, "final_norm": {"scale": ((d,), F32, "ones")},
            "slots": [_slot_defs(cfg, s, experts) for s in slots]}
    if cfg.family == "encdec":
        _, eslots = encoder_layout(cfg)
        defs["encoder_slots"] = [_slot_defs(cfg, s, experts)
                                 for s in eslots]
        defs["enc_norm"] = {"scale": ((d,), F32, "ones")}
    return defs


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(cfg: ModelConfig) -> int:
    n_p, _ = decoder_layout(cfg)
    defs = param_defs(cfg)
    n = lambda t: sum(math.prod(s) for s, _, _ in _leaves(t))  # noqa: E731
    total = (n(defs["embed"]) + n(defs["final_norm"])
             + n_p * sum(n(t) for t in defs["slots"]))
    if "encoder_slots" in defs:
        n_e, _ = encoder_layout(cfg)
        total += (n(defs["enc_norm"])
                  + n_e * sum(n(t) for t in defs["encoder_slots"]))
    return total


def _memory_len(cfg: ModelConfig, seq: int) -> int:
    """The cross-attention memory's length: an encdec's frames (as many
    as the sequence), a vlm's image tokens."""
    if cfg.family == "encdec":
        return seq
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return 0


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's tree of (shape, dtype), stacked per slot over
    the periods."""
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
            c["cross_kv"] = {"k": (shape, BF16), "v": (shape, BF16)}
        out[f"slot{i}"] = c
    return out


def _init_one(shape, init: str, dtype, generator, device) -> torch.Tensor:
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "ssm_a":
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=F32,
                                   device=device))
        return a.expand(shape).to(dtype).contiguous()
    x = torch.randn(shape, generator=generator, dtype=F32, device=device)
    if init == "normal":
        return x.mul_(0.02).to(dtype)
    if init == "scaled":
        fan_in = shape[-2] if len(shape) >= 2 else max(shape[0], 1)
        return x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
    raise ValueError(f"unknown init {init!r}")


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=BF16, experts=None) -> dict:
    """Seeded parameters on ``device``: tensors of rank >= 2 in ``dtype``,
    scalars, 1-D scales and biases in f32 (the reference's defs' dtypes:
    ``train.cast_for_compute`` casts the per-layer 1-D leaves to bf16 as
    well, as the reference's cast of its stacked tree does); MoE layers
    hold ``experts`` (None: all).  ``generator`` must live on
    ``device``."""
    dev = resolve_device(device)
    defs = param_defs(cfg, experts)

    def make(tree):
        return {k: make(v) if isinstance(v, dict) else _init_one(
            v[0], v[2], dtype if len(v[0]) >= 2 else F32, generator, dev)
            for k, v in tree.items()}

    def stack(n: int, slots: list) -> list:
        return [make(slots[l % len(slots)]) for l in range(n * len(slots))]

    n_p, _ = decoder_layout(cfg)
    params = {"embed": make(defs["embed"]),
              "final_norm": make(defs["final_norm"]),
              "layers": stack(n_p, defs["slots"])}
    if "encoder_slots" in defs:
        params["encoder"] = stack(encoder_layout(cfg)[0],
                                  defs["encoder_slots"])
        params["enc_norm"] = make(defs["enc_norm"])
    return params


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
            shape = v[0]
            n = n_stack * math.prod(shape)
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
    """{name: (shape, dtype)} of a training batch: ``tokens`` and
    ``targets`` [B, S] int32; an encdec's ``frames`` [B, S, d] and a
    vlm's ``image_embeds`` [B, num_image_tokens, d], bf16."""
    B, S = shape.global_batch, shape.seq_len
    d = {"tokens": ((B, S), torch.int32), "targets": ((B, S), torch.int32)}
    if cfg.family == "encdec":
        d["frames"] = ((B, S, cfg.d_model), BF16)
    if cfg.family == "vlm":
        d["image_embeds"] = ((B, cfg.num_image_tokens, cfg.d_model), BF16)
    return d


def prefill_batch_defs(cfg: ModelConfig, shape) -> dict:
    d = train_batch_defs(cfg, shape)
    d.pop("targets")
    return d


def decode_batch_defs(cfg: ModelConfig, shape) -> dict:
    return {"tokens": ((shape.global_batch, 1), torch.int32)}
