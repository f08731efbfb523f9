"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` in f32 at smoke widths, on CPU tensors.

* Routing: the port's ``route`` against the reference's routing
  expressions (``moe.py:52-70``: f32 softmax, ``lax.top_k``, the
  renormalized gates, token-major queue places, the ``keep`` mask) on the
  same logits: expert ids, places and ``keep`` equal, gates within 1e-6.
  A router with two equal columns makes ties, which ``lax.top_k`` breaks
  toward the lower id.
* ``moe_apply``: outputs within 1e-5 (f32 products of width 64 and 128,
  summed in another order), every aux value within 1e-6, also where the
  capacity drops tokens (``capacity_factor`` 0.5: ``moe_drop_frac`` >
  0).
* Shares: the outputs of ``experts=range(0, 2)`` and ``range(2, 4)``,
  each holding only its experts' weights, add up to the whole layer's
  within 1e-5; their aux values equal the whole layer's.
* Both packages refuse B * S = 896 (past the 256-token group and not a
  multiple of it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as JM
from repro_torch import configs
from repro_torch.models import moe as TM

ARCH = "jamba-1.5-large-398b"


def _cfg(capacity_factor=1.25):
    return dataclasses.replace(configs.get_smoke_config(ARCH),
                               capacity_factor=capacity_factor)


def _params(seed, cfg, tie=False):
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "wg": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "wu": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "wd": rng.normal(size=(E, ff, d)) / np.sqrt(ff)}
    if tie:
        p["router"][:, 2] = p["router"][:, 1]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(seed, B, S, d):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _jax_route(router, xg, cfg):
    """The reference's routing expressions (repro/models/moe.py:52-70)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G, g, _ = xg.shape
    logits = xg.astype(jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, topk_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    C = JM._capacity(g, cfg)
    onehot = jax.nn.one_hot(topk_idx, E, dtype=jnp.float32)
    flat = onehot.reshape(G, g * k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(G, g, k)
    keep = pos < C
    return topk_idx, gate_vals * keep, pos, keep, C


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _close(a, b, tol):
    return float(np.abs(np.asarray(a) - b.numpy()).max()) <= tol


@pytest.mark.parametrize("tie", (False, True))
@pytest.mark.parametrize("capacity_factor", (1.25, 0.5))
def test_routing_is_the_references(tie, capacity_factor):
    cfg = _cfg(capacity_factor)
    p = _params(1, cfg, tie)
    xg = _x(2, 2, 256, cfg.d_model)
    jidx, jgates, jpos, jkeep, jC = _jax_route(jnp.asarray(p["router"]),
                                               jnp.asarray(xg), cfg)
    r = TM.route(torch.from_numpy(p["router"]), torch.from_numpy(xg), cfg)
    assert r["capacity"] == jC == TM._capacity(256, cfg)
    np.testing.assert_array_equal(np.asarray(jidx), r["experts"].numpy())
    np.testing.assert_array_equal(np.asarray(jpos), r["pos"].numpy())
    np.testing.assert_array_equal(np.asarray(jkeep), r["keep"].numpy())
    assert _close(jgates, r["gates"], 1e-6)
    if tie:   # equal probabilities for experts 1 and 2 somewhere in top-k
        both = ((r["experts"] == 1) | (r["experts"] == 2)).sum(-1) == 2
        assert bool(both.any())
    if capacity_factor < 1:
        assert not bool(r["keep"].all())


# (B, S): one group of 32 tokens, two groups of 256, decode's 4 tokens
SHAPES = ((2, 16), (4, 128), (4, 1))


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("capacity_factor", (1.25, 0.5))
def test_moe_apply_matches_the_reference(B, S, capacity_factor):
    cfg = _cfg(capacity_factor)
    p = _params(3, cfg)
    x = _x(4, B, S, cfg.d_model)
    jout, jaux = JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg)
    out, aux = TM.moe_apply(_t(p), torch.from_numpy(x), cfg)
    assert out.shape == (B, S, cfg.d_model) and out.dtype == torch.float32
    assert _close(jout, out, 1e-5)
    assert set(aux) == set(jaux)
    for k in jaux:
        assert _close(jaux[k], aux[k], 1e-6), k
    if capacity_factor < 1 and B * S > 4:
        assert float(aux["moe_drop_frac"]) > 0


@pytest.mark.parametrize("capacity_factor", (1.25, 0.5))
def test_expert_shares_add_up_to_the_whole_layer(capacity_factor):
    cfg = _cfg(capacity_factor)
    p = _params(5, cfg)
    x = torch.from_numpy(_x(6, 4, 128, cfg.d_model))
    whole, whole_aux = TM.moe_apply(_t(p), x, cfg)
    halves = []
    for share in (range(0, 2), range(2, 4)):
        lo, hi = share.start, share.stop
        ps = {k: torch.from_numpy(v.copy() if k == "router"
                                  else v[lo:hi].copy())
              for k, v in p.items()}
        out, aux = TM.moe_apply(ps, x, cfg, experts=share)
        halves.append(out)
        for k in aux:       # routing and aux run over every expert
            assert torch.equal(aux[k], whole_aux[k]), k
    assert float((halves[0] + halves[1] - whole).abs().max()) <= 1e-5
    assert float(halves[0].abs().max()) > 0 and float(
        halves[1].abs().max()) > 0
    jout, _ = JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x.numpy()), cfg)
    assert _close(jout, halves[0] + halves[1], 1e-5)


def test_share_arguments_are_checked():
    cfg = _cfg()
    assert TM.expert_range(None, 4) == (0, 4)
    assert TM.expert_range(range(1, 3), 4) == (1, 3)
    for bad in ([0, 2], range(3, 5), [], [-1, 0]):
        with pytest.raises(ValueError, match="contiguous"):
            TM.expert_range(bad, 4)
    p = _t(_params(7, cfg))
    x = torch.from_numpy(_x(8, 2, 4, cfg.d_model))
    with pytest.raises(ValueError, match="holds 4 experts"):
        TM.moe_apply(p, x, cfg, experts=range(0, 2))
    defs = TM.moe_defs(cfg, range(2, 4))
    assert defs["wg"].shape == (2, cfg.d_model, cfg.d_ff)
    assert defs["router"].shape == (cfg.d_model, cfg.num_experts)


def test_both_packages_refuse_token_counts_they_cannot_group():
    cfg = _cfg()
    p = _params(9, cfg)
    x = _x(10, 4, 224, cfg.d_model)           # B * S = 896
    with pytest.raises((TypeError, ValueError)):
        JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), cfg)
    with pytest.raises(ValueError, match="B\\*S=896"):
        TM.moe_apply(_t(p), torch.from_numpy(x), cfg)
    for T in (1, 256, 512, 768):              # what both take
        TM.check_tokens(T)
    assert jax_smoke(ARCH).num_experts == cfg.num_experts
