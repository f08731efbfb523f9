"""The port's own copies of the reference's training invariants
(tests/test_train_serve.py): loss falls on Markov data, microbatch
accumulation equals one batch, rematerialisation changes no gradient;
and the registry's shape arithmetic (``active_param_count``,
``model_flops``, the batch defs) against the reference's for every
registered config and shape."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import registry as jax_registry
from repro_torch.common.pytree import param_count, tree_leaves
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.data import TokenDataset
from repro_torch.models import registry
from repro_torch.models.transformer import forward
from repro_torch.train import (
    TrainSettings,
    init_train_state,
    make_train_step,
    train_state_defs,
)
from repro_torch.train.losses import total_loss


def _state(cfg, seed=0):
    return init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_decreases_on_markov_data():
    """Below the unigram floor (ln 256 = 5.55) by 1.5: the model learns
    the bigrams, not just the marginals."""
    cfg = get_smoke_config("qwen3-1.7b")
    data = TokenDataset(cfg.vocab_size, 64, 16, seed=0)
    state = _state(cfg)
    step = make_train_step(cfg, TrainSettings(peak_lr=3e-2, warmup=10,
                                              total_steps=80, remat=False))
    losses = []
    for i in range(80):
        state, m = step(state, _batch(data.batch_at(i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.5, losses[::10]


def test_microbatch_accumulation_equivalence():
    """Four microbatches update as one batch does."""
    cfg = get_smoke_config("qwen2-7b")
    batch = _batch(TokenDataset(cfg.vocab_size, 32, 8, seed=1).batch_at(0))
    outs = {}
    for n in (1, 4):
        state, m = make_train_step(cfg, TrainSettings(
            microbatches=n, remat=False))(_state(cfg), batch)
        outs[n] = (state, float(m["loss"]))
    for a, b in zip(tree_leaves(outs[1][0]["params"]),
                    tree_leaves(outs[4][0]["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-4)
    assert outs[1][1] == pytest.approx(outs[4][1], rel=2e-3)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-large-v2"))
def test_remat_changes_no_gradient(arch):
    """Each period under torch.utils.checkpoint recomputes the same
    activations, whole ("block") or all but the 2-D products' outputs
    ("dots", the reference's ``checkpoint_dots_with_no_batch_dims``):
    the gradients are bit for bit those without it on the CPU."""
    cfg = get_smoke_config(arch)
    params = _state(cfg)["params"]
    b = TokenDataset(cfg.vocab_size, 16, 2, seed=2).batch_at(0)
    kw = {}
    if cfg.family == "encdec":
        kw["memory_embeds"] = torch.from_numpy(np.random.default_rng(0).normal(
            0, 0.02, (2, 16, cfg.d_model)).astype(np.float32))
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    grads = []
    for remat, policy in ((False, "block"), (True, "block"), (True, "dots")):
        logits, _, aux = forward(
            params, dataclasses.replace(cfg, remat_policy=policy),
            tokens=torch.from_numpy(b["tokens"]), mode="train", remat=remat,
            **kw)
        loss, _ = total_loss(logits, torch.from_numpy(b["targets"]), aux)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, c, d in zip(*grads):
        assert torch.equal(a, c) and torch.equal(a, d)
    with pytest.raises(ValueError, match="remat_policy"):
        forward(params, dataclasses.replace(cfg, remat_policy="offload"),
                tokens=torch.from_numpy(b["tokens"]), mode="train",
                remat=True, **kw)


def test_registry_shape_arithmetic_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert registry.active_param_count(cfg) == \
            jax_registry.active_param_count(jcfg), arch
        for name, shape in SHAPES.items():
            jshape = JAX_SHAPES[name]
            assert registry.model_flops(cfg, shape) == \
                jax_registry.model_flops(jcfg, jshape), (arch, name)
            for ours, theirs in (
                    (registry.train_batch_defs, jax_registry.train_batch_defs),
                    (registry.prefill_batch_defs,
                     jax_registry.prefill_batch_defs),
                    (registry.decode_batch_defs,
                     jax_registry.decode_batch_defs)):
                got, want = ours(cfg, shape), theirs(jcfg, jshape)
                assert set(got) == set(want), (arch, name)
                for k, d in got.items():
                    assert d.shape == tuple(want[k].shape), (arch, name, k)
                    assert d.axes == tuple(want[k].axes), (arch, name, k)
                    assert str(d.dtype).split(".")[-1] == \
                        jnp.dtype(want[k].dtype).name, (arch, name, k)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "jamba-1.5-large-398b"))
def test_state_defs_describe_the_state(arch):
    """``train_state_defs`` gives the shapes and dtypes ``init_train_state``
    makes: master weights in ``master_dtype`` (bf16 with Adafactor for
    the 398B config), moments in f32."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, master_dtype=get_config(arch).master_dtype,
                              optimizer=get_config(arch).optimizer)
    defs = train_state_defs(cfg)
    state = _state(cfg)
    got = tree_leaves(state)
    want = [d for d in _def_leaves(defs)]
    assert len(got) == len(want)
    for t, (shape, dtype) in zip(got, want):
        assert tuple(t.shape) == shape and t.dtype == dtype
    assert param_count(state["params"]) == registry.param_count(cfg)


def _def_leaves(tree):
    return [(d.shape, d.dtype) for d in tree_leaves(tree)]
