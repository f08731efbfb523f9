"""Each block of the Jamba smoke config in bf16, the port against the
reference on the same inputs: does a block depart beyond the reference's
own rounding?

Inputs: one period of the smoke config (7 Mamba mixers, attention at
slot 4, MoE at slots 0, 2, 4, 6), the reference's init and its bf16
compute copy (``cast_for_compute``) carried across, and as each block's
input the hidden state the reference's own op-by-op forward reaches
there on a seeded 4 x 32 token batch.

The reference's own spread: the same reference function evaluated
jitted (XLA fuses elementwise ops and keeps f32 between them) and op by
op (``jax.disable_jit``: every op rounded to bf16, as the port's eager
ops are).  A block holds when the port lies within that spread plus one
bf16 step of the block output's largest value (2^-8: a matrix product
summed in another order can round one value either way) of both
evaluations.

What it settled.  Before this test the port's silu was torch's fused
one (``F.silu``), rounded once; the reference's ``jax.nn.silu`` is x *
logistic(x), and XLA expands the logistic to 1 / (1 + exp(-x)) with
every op rounded in bf16, so about 37 % of bf16 values differed by a
step.  With it, 7 of these 15 blocks departed: the Mamba mixer 0.072
from the op-by-op reference at max 4.2 (spread 0.031), the MoE and dense
FFNs 0.016 at 2.8 (spread 0), layer 0 0.60 at 4.3 (spread 0.047).  A
fault of the port, repaired by ``models.layers.silu`` (the reference's
expansion, used by every block that calls silu).  After it, max abs
from the op-by-op reference / the jitted one / the spread, at the
block's scale:

* silu, ln1 (RMS norm), causal conv, attention mixer (layer 4), dense
  FFN (layer 1): 0 / 0 / 0;
* Mamba mixer (layer 0): 1.2e-4 / 0.031 / 0.031 at 4.2;
* MoE FFN (layer 0): 5.5e-4 / 5.5e-4 / 0 at 2.8 (its expert products
  summed in another order: under a bf16 step);
* whole layers 0-7: at most 0.0625 / equal to the spread / 0.047-0.94
  at 4.3-52.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.train.step import cast_for_compute as jax_cast
from repro.train.step import init_train_state
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

ARCH = "jamba-1.5-large-398b"
B, S = 4, 32


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup():
    """-> (cfg, the reference's compute copy of period 0 per slot, the
    port's per layer, the input of each layer from the reference's
    op-by-op forward)."""
    import dataclasses

    cfg = dataclasses.replace(jax_smoke(ARCH), num_layers=8)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        init_train_state(cfg, jax.random.PRNGKey(0))["params"])
    jc = jax_cast(params)
    tc = convert.lm_params_from_reference(jax.tree.map(np.asarray, jc),
                                          device="cpu")
    _, slots = JT.decoder_layout(cfg)
    jp = [jax.tree.map(lambda a: a[0], jc["decoder"][f"slot{i}"])
          for i in range(len(slots))]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    x = JL.embed(jc["embed"], jnp.asarray(toks, jnp.int32))
    pos = jnp.arange(S)
    xs = []
    with jax.disable_jit():
        for i, s in enumerate(slots):
            xs.append(x)
            x = JT._apply_slot(jp[i], s, x, cfg, mode="train",
                               positions=pos, index=None, cache=None,
                               memory=None)[0]
    return cfg, slots, jp, tc["layers"], xs


def _blocks():
    """name -> (reference function of (params, x), port function of
    (params, x), layer)."""
    def attn_ref(cfg):
        from repro.models import attention as JA

        def f(p, x):
            h = JL.rmsnorm(p["ln1"], x, cfg.norm_eps)
            pos = jnp.arange(x.shape[1])
            q = JA.project_q(p["attn"], h, cfg, pos)
            k, v = JA.project_kv(p["attn"], h, cfg, pos)
            return JA.project_out(p["attn"], JA.chunked_attention(
                q, k, v, causal=True, window=cfg.sliding_window), cfg)
        return f

    def attn_port(cfg):
        def f(p, x):
            h = TL.rmsnorm(p["ln1"], x, cfg.norm_eps)
            return TT._attention(p["attn"], h, cfg, mode="train",
                                 positions=torch.arange(x.shape[1]),
                                 index=None, kv=None, backend="interpret")
        return f

    def ffn(cfg, mod, p, x, moe):
        h = mod.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if moe:
            return (JM if mod is JL else TM).moe_apply(p["ffn"], h, cfg)[0]
        return mod.mlp_apply(p["ffn"], h, cfg.act)

    def conv(mod, p, x, cfg):
        h = mod.rmsnorm(p["ln1"], x, cfg.norm_eps)
        xin = (h @ p["mamba"]["in_proj"])[..., :cfg.d_inner]
        return (JS if mod is JL else TS)._causal_conv(
            xin, p["mamba"]["conv_w"], p["mamba"]["conv_b"], None)[0]

    def slot_ref(cfg, i):
        slots = JT.decoder_layout(cfg)[1]
        return lambda p, x: JT._apply_slot(
            p, slots[i], x, cfg, mode="train", positions=jnp.arange(
                x.shape[1]), index=None, cache=None, memory=None)[0]

    def slot_port(cfg, i):
        slots = TT.decoder_layout(cfg)[1]
        return lambda p, x: TT._apply_slot(
            p, slots[i], x, cfg, mode="train", positions=torch.arange(
                x.shape[1]), index=None, cache=None, backend="interpret",
            experts=None)[0]

    return {
        "silu": (lambda cfg: lambda p, x: jax.nn.silu(x),
                 lambda cfg: lambda p, x: TL.silu(x), 0),
        "ln1": (lambda cfg: lambda p, x: JL.rmsnorm(p["ln1"], x,
                                                    cfg.norm_eps),
                lambda cfg: lambda p, x: TL.rmsnorm(p["ln1"], x,
                                                    cfg.norm_eps), 0),
        "conv": (lambda cfg: lambda p, x: conv(JL, p, x, cfg),
                 lambda cfg: lambda p, x: conv(TL, p, x, cfg), 0),
        "mamba_mixer": (
            lambda cfg: lambda p, x: JS.mamba_apply(
                p["mamba"], JL.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg),
            lambda cfg: lambda p, x: TS.mamba_apply(
                p["mamba"], TL.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                backend="interpret"), 0),
        "attention_mixer": (attn_ref, attn_port, 4),
        "moe_ffn": (lambda cfg: lambda p, x: ffn(cfg, JL, p, x, True),
                    lambda cfg: lambda p, x: ffn(cfg, TL, p, x, True), 0),
        "dense_ffn": (lambda cfg: lambda p, x: ffn(cfg, JL, p, x, False),
                      lambda cfg: lambda p, x: ffn(cfg, TL, p, x, False), 1),
        **{f"layer{i}": (lambda cfg, i=i: slot_ref(cfg, i),
                         lambda cfg, i=i: slot_port(cfg, i), i)
           for i in range(8)},
    }


BLOCKS = _blocks()


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_block_within_the_references_own_rounding(block):
    cfg, _, jp, tp, xs = _setup()
    make_ref, make_port, layer = BLOCKS[block]
    ref, port = make_ref(cfg), make_port(cfg)
    x = xs[layer]
    fused = _np(jax.jit(ref)(jp[layer], x))
    with jax.disable_jit():
        op_by_op = _np(ref(jp[layer], x))
    got = port(tp[layer], _t(np.asarray(x)))
    assert got.dtype == torch.bfloat16
    got = _np(got)
    spread = float(np.abs(fused - op_by_op).max())
    step = 2.0 ** -8 * float(np.abs(op_by_op).max())
    for name, want in (("op by op", op_by_op), ("jitted", fused)):
        d = float(np.abs(got - want).max())
        assert d <= spread + step, (block, name, d, spread, step)


def test_silu_gives_the_same_bits_in_place_and_under_autograd():
    """``models.layers.silu`` runs its five bf16 ops in place outside
    autograd and out of place under it: the same values, the input left
    as it was, and a gradient under autograd."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, 77)).astype(np.float32) * 4).to(torch.bfloat16)
    before = x.clone()
    y = TL.silu(x)
    assert torch.equal(x, before)
    xg = x.clone().requires_grad_()
    yg = TL.silu(xg)
    assert torch.equal(y, yg.detach())
    yg.float().sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
