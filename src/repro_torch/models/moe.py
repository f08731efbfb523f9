"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``):
GShard-style capacity dispatch over groups of tokens, top-k routing, a
SwiGLU expert each, and the Switch load-balance and router z losses.

Tokens are grouped [G, g, d] (g = min(group_size, B * S)); each token's
top-k experts take it in queue order (token-major over the group's (g,
k) slots) up to a capacity C per expert per group, and a token past
capacity is dropped for that expert.  Routing, capacity, the ``keep``
mask and the aux values always run over all ``num_experts``.

A card may hold a share of the experts (expert parallelism, as the
reference's ``"ep"`` sharding of ``wg``/``wu``/``wd``): ``experts``
names a contiguous range of global expert ids whose weights the
parameters hold, and only those experts' slots of the dispatch and
combine are computed and summed.  The outputs of the shares of one
layer add up to the whole layer's; nothing here stands in for the other
cards.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import silu

F32, BF16 = torch.float32, torch.bfloat16
GROUP_SIZE = 256   # the reference's default group size


def expert_range(experts, num_experts: int) -> tuple[int, int]:
    """``experts`` (None: all; else a contiguous run of ids, such as a
    ``range``) -> (lo, hi)."""
    if experts is None:
        return 0, num_experts
    ids = [int(e) for e in experts]
    if not ids or ids != list(range(ids[0], ids[0] + len(ids))) \
            or ids[0] < 0 or ids[-1] >= num_experts:
        raise ValueError(f"experts must be a contiguous run of ids in "
                         f"0..{num_experts - 1}; got {ids}")
    return ids[0], ids[-1] + 1


def moe_defs(cfg: ModelConfig, experts=None) -> dict:
    """{name: ParamDef} of one MoE layer holding ``experts``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lo, hi = expert_range(experts, E)
    return {
        "router": ParamDef((d, E), F32, ("fsdp", None), "scaled"),
        "wg": ParamDef((hi - lo, d, ff), BF16, ("ep", "fsdp", None),
                       "scaled"),
        "wu": ParamDef((hi - lo, d, ff), BF16, ("ep", "fsdp", None),
                       "scaled"),
        "wd": ParamDef((hi - lo, ff, d), BF16, ("ep", None, "fsdp"),
                       "scaled"),
    }


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = tokens_per_group * cfg.num_experts_per_tok / cfg.num_experts
    c = int(math.ceil(c * cfg.capacity_factor))
    return max(c, 4)


def check_tokens(T: int, group_size: int = GROUP_SIZE) -> None:
    """Raises for a token count the reference's grouping refuses."""
    g = min(group_size, T)
    if g and T % g:
        raise ValueError(
            f"an MoE layer over B*S={T} tokens: the reference groups them "
            f"by min({group_size}, B*S) = {g} and refuses a count that is "
            "not a multiple of it")


def _top_k(probs: torch.Tensor, k: int):
    """lax.top_k: the k largest, the lower index first among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig) -> dict:
    """The routing of grouped tokens xg [G, g, d] over all experts ->
    {"logits", "probs" [G, g, E] f32; "experts" [G, g, k] top-k ids;
    "gates" [G, g, k] renormalized, 0 where dropped; "pos" [G, g, k]
    queue places; "keep" [G, g, k]; "onehot" [G, g, k, E]; "pos_oh" [G,
    g, k, C]; "capacity" C}."""
    G, g, _ = xg.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xg.to(F32) @ router.to(F32)                     # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = _top_k(probs, k)                   # [G, g, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    C = _capacity(g, cfg)
    onehot = F.one_hot(topk_idx, E).to(F32)                  # [G, g, k, E]
    # each (token, slot)'s place in its expert's queue, token-major
    flat = onehot.reshape(G, g * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(pos * flat, dim=-1).reshape(G, g, k)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    # overflow -> an all-zero row, as one_hot of index C
    pos_oh = F.one_hot(torch.where(keep, pos, float(C)).long(),
                       C + 1)[..., :C].to(F32)               # [G, g, k, C]
    return {"logits": logits, "probs": probs, "experts": topk_idx,
            "gates": gate_vals, "pos": pos, "keep": keep, "onehot": onehot,
            "pos_oh": pos_oh, "capacity": C}


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              group_size: int = GROUP_SIZE, experts=None):
    """x [B, S, d] -> (out [B, S, d], {"moe_lb_loss", "moe_z_loss",
    "moe_drop_frac"}).  ``p``'s expert weights hold ``experts``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    lo, hi = expert_range(experts, E)
    if p["wg"].shape[0] != hi - lo:
        raise ValueError(f"the layer holds {p['wg'].shape[0]} experts, not "
                         f"the {hi - lo} of experts {lo}..{hi - 1}")
    T = B * S
    check_tokens(T, group_size)
    g = min(group_size, T)
    G = T // g
    xg = x.reshape(G, g, d)
    r = route(p["router"], xg, cfg)
    C, onehot, pos_oh = r["capacity"], r["onehot"], r["pos_oh"]

    held = onehot[..., lo:hi]
    dispatch = torch.einsum("gske,gskc->gsec", held, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", held, pos_oh, r["gates"])

    Eh = hi - lo
    ex_in = torch.einsum("gsd,gsec->gecd", xg.to(F32), dispatch).to(x.dtype)
    xe = ex_in.permute(1, 0, 2, 3).reshape(Eh, G * C, d)     # per expert
    h = silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    ex_out = torch.bmm(h, p["wd"]).reshape(Eh, G, C, d).permute(1, 0, 2, 3)
    out = torch.einsum("gecd,gsec->gsd", ex_out.to(F32),
                       combine).to(x.dtype)
    out = out.reshape(B, S, d)

    # Switch load-balance loss: E * sum_e f_e * P_e (f_e the pre-drop
    # routing fraction per expert, normalized by k so sum_e f_e == 1)
    f_e = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1)) / k
    p_e = torch.mean(r["probs"], dim=(0, 1))
    lb_loss = E * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1)))
    dropped = 1.0 - torch.mean(r["keep"].to(F32))
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}
    return out, aux
