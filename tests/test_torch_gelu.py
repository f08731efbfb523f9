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

StarCoder2's whole bf16 forward departs from the reference evaluated op
by op by 0.015625 (``test_torch_lm.py``'s margin-rule test) where every
silu config is bit for bit.  The departure is located here: torch's CPU
GEMM and XLA's ``jnp.dot`` round a few values of the same bf16 product one
bf16 step apart — in ``x @ p["wi"]`` of layers 2 and 3, and in the
unembedding product.  With the reference's products in their place the
port's MLP and logits are the reference's bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.step import cast_for_compute as jax_cast
from repro.train.step import init_train_state
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

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
def _compute_params():
    """The reference's bf16 compute copy of StarCoder2's smoke config at
    ``PRNGKey(0)``, and the port's carried across."""
    cfg = jax_smoke(ARCH)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        init_train_state(cfg, jax.random.PRNGKey(0))["params"])
    jc = jax_cast(params)
    return cfg, jc, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jc), device="cpu")


def _mlp_params():
    """Layer 0's MLP of ``_compute_params``, in both packages."""
    cfg, jc, tc = _compute_params()
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


class _JaxProduct:
    """A weight whose ``x @ w`` is XLA's ``jnp.dot`` evaluated op by op
    (torch's ``Tensor.__matmul__`` gives way to ``__rmatmul__`` for a
    non-tensor operand), so the port's own code runs with that one
    product swapped."""

    def __init__(self, w):
        self.w = w

    def __rmatmul__(self, x):
        with jax.disable_jit():
            y = jnp.dot(jnp.asarray(_np(x), jnp.bfloat16), self.w)
        return torch.tensor(_np(y)).to(torch.bfloat16)


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per value, how many bf16 steps apart two bf16 tensors lie."""
    return np.abs(a.view(torch.int16).numpy().astype(np.int64)
                  - b.view(torch.int16).numpy().astype(np.int64))


def test_starcoder2_bf16_departure_is_the_products_rounding(
        monkeypatch, record_property):
    """The bf16 forward of ``test_forward_bf16_matches_under_the_margin_
    rule`` (seed 0, tokens (2, 16)), the port's MLP and unembedding inputs
    captured.  At layers 2 and 3 the port's gelu MLP with the reference's
    product in place of ``x @ p["wi"]`` is the reference's MLP output bit
    for bit; torch's own product differs from it by one bf16 step at a
    few values.  With every MLP output the reference's (op by op, on the
    port's own input) the unembedding's input is the reference's bit for
    bit, and the logits are too once the unembedding product is the
    reference's: the rest of the departure (0.0009765625) is that
    product's rounding."""
    cfg, params, ours = _compute_params()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    jp = [jax.tree.map(lambda a, l=l: a[l], params["decoder"]["slot0"]["ffn"])
          for l in range(cfg.num_layers)]

    def ref_mlp(l, x):
        with jax.disable_jit():
            return JL.mlp_apply(jp[l], jnp.asarray(_np(x), jnp.bfloat16),
                                cfg.act)

    seen, hidden = [], []
    mlp, unembed = TT.mlp_apply, TT.unembed
    monkeypatch.setattr(TT, "mlp_apply", lambda p, x, act: (
        seen.append(x.clone()), mlp(p, x, act))[1])
    TT.forward(ours, cfg, tokens=torch.as_tensor(toks), mode="train")
    counts = {}
    for l in (2, 3):
        x, tp = seen[l], ours["layers"][l]["ffn"]
        want = torch.tensor(_np(ref_mlp(l, x))).to(torch.bfloat16)
        swapped = TL.mlp_apply({**tp, "wi": _JaxProduct(jp[l]["wi"])}, x,
                               cfg.act)
        assert torch.equal(swapped.view(torch.int16),
                           want.view(torch.int16)), l
        steps = _bf16_steps(x @ tp["wi"], _JaxProduct(jp[l]["wi"])
                            .__rmatmul__(x))
        counts[l] = int((steps > 0).sum())
        assert steps.max() <= 1 and counts[l] <= 0.01 * steps.size, l
        record_property(f"wi_product_values_differing_layer{l}", counts[l])
    assert sum(counts.values()) > 0     # the departure is still there

    # every MLP output the reference's: the rest is the unembedding
    layer_of = {id(lay["ffn"]): l for l, lay in enumerate(ours["layers"])}
    monkeypatch.setattr(TT, "mlp_apply", lambda p, x, act: torch.tensor(
        _np(ref_mlp(layer_of[id(p)], x))).to(torch.bfloat16))
    monkeypatch.setattr(TT, "unembed", lambda p, x: (
        hidden.append(x.clone()), unembed(p, x))[1])
    got = TT.forward(ours, cfg, tokens=torch.as_tensor(toks),
                     mode="train")[0]
    jhidden = []
    junembed = JT.unembed
    monkeypatch.setattr(JT, "unembed", lambda p, x: (
        jhidden.append(_np(x)), junembed(p, x))[1])
    with jax.disable_jit():
        want = JT.forward(params, cfg, tokens=jnp.asarray(toks),
                          mode="train")[0]
    want = torch.tensor(_np(want)).to(torch.bfloat16)
    assert np.array_equal(_np(hidden[0]), jhidden[0])
    w = params["embed"]["unembed"]
    assert torch.equal(_JaxProduct(w).__rmatmul__(hidden[0]).view(
        torch.int16), want.view(torch.int16))
    steps = _bf16_steps(got, want)
    assert steps.max() <= 1
    record_property("unembed_product_values_differing",
                    int((steps > 0).sum()))
    print(f"wi products differing at layers 2, 3: {counts}; logits "
          f"differing {int((steps > 0).sum())} of {steps.size}, by at most "
          f"{float(np.abs(_np(got) - _np(want)).max())}")
