"""The f32 gradients of the port's ``total_loss`` composed with its
``forward`` against ``jax.value_and_grad`` of the reference's.

Tolerance: each leaf within 1e-4 of its largest value.  The MoE case adds
QK-norm: without it the smoke configs' seeded attention scores (spread
near 100) turn f32 rounding into gradient differences of 3-5e-4 of the
largest, the port's plain attention against the reference as much as
K7b's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import forward as jax_forward
from repro.train import total_loss as jax_total_loss
from repro.train.step import init_train_state as jax_init
from repro_torch import convert
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenDataset
from repro_torch.models.transformer import forward
from repro_torch.train import total_loss


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch,qk_norm", [("qwen3-1.7b", False),
                                          ("moonshot-v1-16b-a3b", True)])
def test_f32_gradients_match_reference(arch, qk_norm):
    """``jax.value_and_grad`` of the reference's ``total_loss`` composed
    with its ``forward`` (f32 params, no cast), against autograd through
    the port's (K7's plain version and ``attention_bwd_ref`` under
    ``backend="cuda"``; autograd of ``attention_ref`` under
    ``"interpret"``)."""
    cfg = dataclasses.replace(jax_smoke(arch), use_qk_norm=True) \
        if qk_norm else jax_smoke(arch)
    tcfg = dataclasses.replace(get_smoke_config(arch), use_qk_norm=True) \
        if qk_norm else get_smoke_config(arch)
    b = TokenDataset(cfg.vocab_size, 32, 4, seed=1).batch_at(0)
    params = jax_init(cfg, jax.random.PRNGKey(1))["params"]

    def loss_fn(p):
        logits, _, aux = jax_forward(p, cfg, tokens=jnp.asarray(b["tokens"]),
                                     mode="train")
        return jax_total_loss(logits, jnp.asarray(b["targets"]), aux)[0]

    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = tree_leaves(convert.lm_params_from_reference(_np(wg),
                                                        device="cpu"))
    tp = convert.lm_params_from_reference(_np(params), device="cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_()
    for backend in ("cuda", "interpret"):
        logits, _, aux = forward(tp, tcfg, tokens=torch.from_numpy(
            b["tokens"]), mode="train", backend=backend)
        loss, _ = total_loss(logits, torch.from_numpy(b["targets"]), aux)
        assert float(loss.detach()) == pytest.approx(float(wl), rel=1e-5)
        got = torch.autograd.grad(loss, leaves)
        for path, g, w in zip(tree_paths(tp), got, want):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * scale, (backend,
                                                                 path)
