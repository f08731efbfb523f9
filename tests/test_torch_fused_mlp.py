"""Port parity: the per-packet MLP + argmax (K3's function).

The JAX ``fused_mlp_classify`` (Pallas ``_classify_kernel``, interpret
mode on the CPU) against the port's ``fused_mlp_classify`` on CPU tensors
(its plain version).  Logits agree within rtol=atol=1e-5 (the two
frameworks sum in different orders); verdicts may differ only on rows
whose top-two margin is within ``testing.MARGIN``, and the test counts
those rows.  Ties go to the lowest class index in both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_mlp as jfm  # noqa: E402

from repro_torch.kernels import fused_mlp as tfm  # noqa: E402
from repro_torch.testing import random_mlp, verdict_mismatches  # noqa: E402

WIDTHS = [(28, 16, 8, 2), (5, 7, 3), (64, 128, 128, 10), (1, 4, 2)]


def _x(rows, d0, seed):
    return (np.random.default_rng(seed).normal(size=(rows, d0)) * 3
            ).astype(np.float32)


@pytest.mark.parametrize("widths", WIDTHS)
def test_classify_matches_reference(widths):
    ws, bs = random_mlp(widths, seed=len(widths))
    x = _x(200, widths[0], seed=1)
    jv = np.asarray(jfm.fused_mlp_classify(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs]))
    jl = np.asarray(jfm.fused_mlp(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs]))
    tx = torch.as_tensor(x)
    tv = tfm.fused_mlp_classify(tx, ws, bs).numpy()
    tl = tfm.mlp_ref(tx, [torch.as_tensor(w) for w in ws],
                     [torch.as_tensor(b) for b in bs]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    bad, close = verdict_mismatches(tv, jl)
    print(f"widths {widths}: {close} of {len(x)} rows within the margin")
    assert bad == 0 and close <= len(x) // 100
    outside = verdict_mismatches(jv, jl)[0]
    assert outside == 0
    assert tv.dtype == np.int32 and tv.shape == (200,)


@pytest.mark.parametrize("tie", ["pair", "all"])
def test_ties_go_to_lowest_index(tie):
    ws, bs = random_mlp((6, 5, 4), seed=7)
    if tie == "pair":
        # classes 1 and 2 identical and dominant: every row ties
        ws[1][:, 2] = ws[1][:, 1]
        bs[1][1] = bs[1][2] = 50.0
        want = 1
    else:
        ws[1][:] = 0.0
        bs[1][:] = 0.0
        want = 0
    x = _x(64, 6, seed=2)
    jv = np.asarray(jfm.fused_mlp_classify(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs]))
    tv = tfm.fused_mlp_classify(torch.as_tensor(x), ws, bs).numpy()
    assert (tv == want).all()
    np.testing.assert_array_equal(tv, jv)


def test_packing_round_trips_and_envelope():
    ws, bs = random_mlp((28, 16, 8, 2), seed=0)
    packed = tfm.pack_params(ws, bs)
    assert packed.widths == (28, 16, 8, 2)
    assert packed.w_flat.numel() == 28 * 16 + 16 * 8 + 8 * 2
    for w, b, pw, pb in zip(ws, bs, *packed.layers()):
        np.testing.assert_array_equal(pw.numpy(), w)
        np.testing.assert_array_equal(pb.numpy(), b)
    assert tfm.ops.mlp_envelope_reason((28, 16, 8, 2)) is None
    assert "width" in tfm.ops.mlp_envelope_reason((300, 2))
    assert "layers" in tfm.ops.mlp_envelope_reason((4,) * 18)
    assert "shared memory" in tfm.ops.mlp_envelope_reason((256,) * 4)
    with pytest.raises(ValueError, match="chain"):
        tfm.pack_params([ws[0], ws[2]], [bs[0], bs[2]])


def test_launch_wrapper_refuses_cpu_tensors():
    ws, bs = random_mlp((5, 7, 3), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_classify_launch(torch.zeros(4, 5),
                                      tfm.pack_params(ws, bs))
