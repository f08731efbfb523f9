"""The f32 gradients of the port's ``total_loss`` composed with its
``forward`` against ``jax.value_and_grad`` of the reference's.

Tolerance: each leaf within 1e-4 of its largest value.  The MoE case adds
QK-norm: without it the smoke configs' seeded attention scores (spread
near 100) turn f32 rounding into gradient differences of 3-5e-4 of the
largest, the port's plain attention against the reference as much as
K7b's plain version.  The hybrid case (Jamba smoke, where the seeded
model amplifies rounding most) adds twice the reference's own spread:
how far its gradients move, relative to each leaf's largest value, when
only its scan's sums are reordered (its chunked associative scan against
its sequential oracle, measured in the test: 1.28e-3); the port on
``"cuda"`` (SelectiveScanFn: the plain forward and
``selective_scan_bwd_ref``) and on ``"interpret"`` (autograd through the
plain recurrence) lands within 1.76e-3, worst at a Mamba mixer's
``x_proj``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.selective_scan.ref import (
    selective_scan_ref as jax_scan_ref,
)
from repro.models import ssm as jax_ssm
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
                                          ("moonshot-v1-16b-a3b", True),
                                          ("jamba-1.5-large-398b", False)])
def test_f32_gradients_match_reference(arch, qk_norm, monkeypatch):
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
    spread = 0.0
    if cfg.family == "hybrid":
        monkeypatch.setattr(jax_ssm, "_ssm_scan_chunked",
                            lambda dA, dBx, C, h0, chunk=256:
                            jax_scan_ref(dA, dBx, C, h0))
        _, sg = jax.jit(jax.value_and_grad(loss_fn))(params)
        spread = max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(tree_leaves(
                         convert.lm_params_from_reference(_np(sg),
                                                          device="cpu")),
                         want))
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
            assert float((g - w).abs().max()) <= (1e-4 + 2 * spread) * scale, (
                backend, path)
