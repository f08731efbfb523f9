"""LM training (``repro_torch.train``, ``data.tokens``, ``convert``)
against the JAX package: the token stream bit for bit, the losses, the
whole train step after 1 and 3 steps (dense and MoE smoke configs) from
one state carried across, and the f32 gradients of ``total_loss``
composed with ``forward``.

Tolerances: losses within 1e-6 relative (the same f32 expressions).  The
train step in bf16, as the reference's microbatch test bounds the same
function summed in another order (tests/test_train_serve.py:36-57):
loss within 2e-3 relative, params within rtol 2e-2 and atol 2e-4, under
the reference's default schedule (a large step makes Adam's first update
the sign of each gradient, so bf16 rounding near a zero gradient moves a
weight by twice the step).  The f32 gradients are held in
``test_torch_train_grads.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.tokens import TokenDataset as JaxTokens
from repro.models.transformer import forward as jax_forward
from repro.train import cross_entropy as jax_ce
from repro.train import total_loss as jax_total_loss
from repro.train.step import TrainSettings as JaxSettings
from repro.train.step import cast_for_compute as jax_cast
from repro.train.step import init_train_state as jax_init
from repro.train.step import make_train_step as jax_make_step
from repro_torch import convert
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenDataset
from repro_torch.train import (
    TrainSettings,
    cast_for_compute,
    cross_entropy,
    make_train_step,
    total_loss,
)
from repro_torch.train.losses import IGNORE


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed,host,num_hosts,step", [
    (0, 0, 1, 0), (0, 0, 1, 7), (3, 1, 2, 5), (11, 3, 4, 123)])
def test_token_batches_are_the_references(seed, host, num_hosts, step):
    kw = dict(seed=seed, host_id=host, num_hosts=num_hosts)
    got = TokenDataset(97, 24, 8, **kw).batch_at(step)
    want = JaxTokens(97, 24, 8, **kw).batch_at(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = iter(TokenDataset(97, 24, 8, **kw))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  want["tokens"] if step == 0 else
                                  JaxTokens(97, 24, 8, **kw).batch_at(0)
                                  ["tokens"])


@pytest.mark.parametrize("with_moe", (False, True))
def test_losses_match_reference(with_moe):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    targets[0, :3] = IGNORE
    targets[2, -1] = IGNORE
    aux = ({"moe_lb_loss": np.float32(1.37), "moe_z_loss": np.float32(2.9),
            "moe_drop_frac": np.float32(0.1)} if with_moe else {})
    for got, want in zip(cross_entropy(torch.from_numpy(logits).bfloat16(),
                                       torch.from_numpy(targets)),
                         jax_ce(jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(targets))):
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    gl, gm = total_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                        {k: torch.tensor(v) for k, v in aux.items()})
    wl, wm = jax_total_loss(jnp.asarray(logits), jnp.asarray(targets),
                            {k: jnp.asarray(v) for k, v in aux.items()})
    assert float(gl) == pytest.approx(float(wl), rel=1e-6)
    assert set(gm) == set(wm)
    for k in gm:
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=1e-6)


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _fused_spread(cfg, params, b) -> float:
    """How far the reference's bf16 loss moves between its jitted
    evaluation (XLA fuses elementwise ops and keeps f32 between them) and
    its op-by-op one (``jax.disable_jit``: every op rounded to bf16, as
    the port's eager ops are): the loss of ``forward`` on its compute
    copy at ``params`` and batch ``b``."""
    def loss(p):
        logits, _, aux = jax_forward(jax_cast(p), cfg,
                                     tokens=jnp.asarray(b["tokens"]),
                                     mode="train")
        return jax_total_loss(logits, jnp.asarray(b["targets"]), aux)[0]

    fused = float(jax.jit(loss)(params))
    with jax.disable_jit():
        return abs(fused - float(loss(params)))


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"))
def test_train_step_matches_reference(arch):
    """The hybrid case runs with QK-norm, and its loss bound adds twice
    ``_fused_spread`` at step 1 (0.012 on its 6.17: the Mamba mixers' gated
    outputs and the MoE routing turn single bf16 roundings into loss
    moves, in either package); the port sits 0.019 from the jitted
    reference and 0.002 from its op-by-op evaluation."""
    cfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, use_qk_norm=True)
        tcfg = dataclasses.replace(tcfg, use_qk_norm=True)
    data = TokenDataset(cfg.vocab_size, 32, 4, seed=0)
    settings = dict(remat=False, total_steps=20)
    state = jax_init(cfg, jax.random.PRNGKey(0))
    spread = (_fused_spread(cfg, state["params"], data.batch_at(0))
              if cfg.family == "hybrid" else 0.0)
    tstate = convert.train_state_from_reference(_np(state), device="cpu")
    step = jax.jit(jax_make_step(cfg, JaxSettings(**settings)))
    tstep = make_train_step(tcfg, TrainSettings(**settings))
    for i in range(3):
        b = data.batch_at(i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, _batch(b))
        assert abs(float(tm["loss"]) - float(m["loss"])) <= (
            2e-3 * abs(float(m["loss"])) + 2 * spread), i
        assert float(tm["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6)
        assert int(tstate["step"]) == int(state["step"]) == i + 1
        if i in (0, 2):
            want = convert.train_state_from_reference(_np(state),
                                                      device="cpu")
            for g, w in zip(tree_leaves(tstate["params"]),
                            tree_leaves(want["params"])):
                np.testing.assert_allclose(g.float().numpy(),
                                           w.float().numpy(), rtol=2e-2,
                                           atol=2e-4)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"))
def test_compute_copy_dtypes_are_the_references(arch):
    """Each leaf of the port's bf16 compute copy in the dtype the
    reference's ``cast_for_compute`` gives it on its scan-stacked tree:
    the per-layer 1-D leaves (norm scales, biases, QK-norm scales, the
    Mamba mixer's D, dt_bias, conv_b and norm) are rank 2 there and so
    bf16; the embedding's and final norms' 1-D leaves stay f32."""
    cfg = jax_smoke(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a,
                          jax_init(cfg, jax.random.PRNGKey(0))["params"])
    want = convert.lm_params_from_reference(_np(jax_cast(params)),
                                            device="cpu")
    got = cast_for_compute(convert.lm_params_from_reference(_np(params),
                                                            device="cpu"))
    assert tree_paths(got) == tree_paths(want)
    dtypes = set()
    for path, g, w in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(want)):
        assert g.dtype == w.dtype, path
        dtypes.add((path[0], g.dim(), g.dtype))
    assert ("layers", 1, torch.bfloat16) in dtypes
    assert ("final_norm", 1, torch.float32) in dtypes
