"""``models.layers.gelu`` and the gelu MLP against the reference in bf16.

The reference's ``jax.nn.gelu`` (its tanh form, ``repro/models/layers.py``'s
``mlp_apply``) evaluates x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715
* x^3)))) with every op rounded in bf16, jitted or not (the two give the
same bits here).  torch's fused gelu rounds once and differs from it on
about 43 % of bf16 values; the port's expansion matches it bit for bit.
StarCoder2 is the configuration with a gelu MLP: its smoke config's MLP
block, on the reference's init carried across, lies within the
reference's own jit-against-op-by-op spread plus one bf16 step of the
output's largest value (a matrix product summed in another order can
round a value either way), as ``test_torch_hybrid_bf16.py`` holds the silu
blocks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.train.step import cast_for_compute as jax_cast
from repro.train.step import init_train_state
from repro_torch import convert
from repro_torch.models import layers as TL

ARCH = "starcoder2-15b"


def _values(n: int, seed: int = 0) -> np.ndarray:
    """n values N(0, 3^2), rounded to bf16, as f32."""
    x = np.random.default_rng(seed).normal(0, 3, n).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_gelu_gives_the_references_bits_in_bf16():
    """200,000 seeded bf16 values: the port's gelu in place (no grad) and
    under autograd equal jax.nn.gelu jitted and op by op, bit for bit;
    the input is left as it was."""
    x = _values(200_000)
    xj = jnp.asarray(x, jnp.bfloat16)
    jitted = _np(jax.jit(jax.nn.gelu)(xj))
    with jax.disable_jit():
        op_by_op = _np(jax.nn.gelu(xj))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = xt.clone()
    got = TL.gelu(xt)
    assert got.dtype == torch.bfloat16
    assert torch.equal(xt, before)
    for want in (jitted, op_by_op):
        assert np.array_equal(_np(got), want)
    # under autograd: the same bits out of place, and a gradient
    xg = xt[:4096].clone().requires_grad_()
    yg = TL.gelu(xg)
    assert np.array_equal(_np(yg.detach()), jitted[:4096])
    yg.float().sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


def test_gelu_keeps_the_fused_form_in_f32():
    """In f32 the port's gelu is torch's fused tanh gelu, within the last
    bit of the reference's (f32 rounding of the expansion)."""
    x = np.random.default_rng(1).normal(0, 3, 10_000).astype(np.float32)
    xt = torch.from_numpy(x)
    got = TL.gelu(xt)
    assert torch.equal(got, F.gelu(xt, approximate="tanh"))
    want = _np(jax.nn.gelu(jnp.asarray(x)))
    assert float(np.abs(got.numpy() - want).max()) <= 2e-6


@functools.lru_cache(maxsize=None)
def _mlp_params():
    """The reference's bf16 compute copy of StarCoder2's smoke layer 0
    MLP, and the port's carried across."""
    cfg = jax_smoke(ARCH)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        init_train_state(cfg, jax.random.PRNGKey(0))["params"])
    jc = jax_cast(params)
    tc = convert.lm_params_from_reference(jax.tree.map(np.asarray, jc),
                                          device="cpu")
    jp = jax.tree.map(lambda a: a[0], jc["decoder"]["slot0"]["ffn"])
    return cfg, jp, tc["layers"][0]["ffn"]


def test_starcoder2_gelu_mlp_within_the_references_own_rounding():
    cfg, jp, tp = _mlp_params()
    assert cfg.act == "gelu"
    # the biases drawn non-zero: the init's are zeros
    rng = np.random.default_rng(2)
    bi = rng.normal(0, 0.5, cfg.d_ff).astype(np.float32)
    bd = rng.normal(0, 0.5, cfg.d_model).astype(np.float32)
    jp = {**jp, "bi": jnp.asarray(bi), "bd": jnp.asarray(bd)}
    tp = {**tp, "bi": torch.from_numpy(bi), "bd": torch.from_numpy(bd)}
    x = rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)

    def ref(p, x):
        return JL.mlp_apply(p, x, cfg.act)

    jitted = _np(jax.jit(ref)(jp, xj))
    with jax.disable_jit():
        op_by_op = _np(ref(jp, xj))
    got = TL.mlp_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg.act)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    spread = float(np.abs(jitted - op_by_op).max())
    step = 2.0 ** -8 * float(np.abs(op_by_op).max())
    for name, want in (("op by op", op_by_op), ("jitted", jitted)):
        d = float(np.abs(got - want).max())
        assert d <= spread + step, (name, d, spread, step)
