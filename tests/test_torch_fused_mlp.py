"""Port parity: the per-packet MLP + argmax (K3's function) and the MLP
to logits (K5's).

The JAX ``fused_mlp_classify`` and ``fused_mlp`` (Pallas
``_classify_kernel`` and ``_kernel``, interpret mode on the CPU) against
the port's ``fused_mlp_classify`` and ``fused_mlp`` on CPU tensors (their
plain versions).  Logits agree within rtol=atol=1e-5 (the two frameworks
sum in different orders); verdicts may differ only on rows whose top-two
margin is within ``testing.MARGIN``, and the test counts those rows.
Ties go to the lowest class index in both.  The envelope: every MLP the
JAX package lowers (widths up to 128, any depth up to 16 layers) is one
the port's kernels take, whatever its parameter bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pallas_backend  # noqa: E402
from repro.core import stageir as js  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.kernels import fused_mlp as jfm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import cuda_backend  # noqa: E402
from repro_torch.core import stageir as ts  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.kernels import fused_mlp as tfm  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    he_mlp,
    random_mlp,
    verdict_mismatches,
)

FULL = (30,) + (128,) * 10 + (2,)       # the design space's deepest DNN

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
    # parameters beyond shared memory are read from device memory
    assert tfm.ops.mlp_envelope_reason((256,) * 4) is None
    with pytest.raises(ValueError, match="chain"):
        tfm.pack_params([ws[0], ws[2]], [bs[0], bs[2]])


def test_launch_wrapper_refuses_cpu_tensors():
    ws, bs = random_mlp((5, 7, 3), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_classify_launch(torch.zeros(4, 5),
                                      tfm.pack_params(ws, bs))


@pytest.mark.parametrize("widths", [(7, 16, 8, 2), FULL])
def test_logits_match_reference(widths):
    """K5's function: logits within rtol=atol=1e-5 of the JAX
    ``fused_mlp``, on the AD widths and at full width."""
    ws, bs = he_mlp(widths, seed=3)
    x = _x(150, widths[0], seed=4)
    jl = np.asarray(jfm.fused_mlp(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs]))
    tl = tfm.fused_mlp(torch.as_tensor(x), ws, bs)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (150, 2)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    packed = tfm.pack_params(ws, bs)
    np.testing.assert_array_equal(
        tfm.fused_mlp_packed(torch.as_tensor(x), packed).numpy(),
        tl.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_launch(torch.as_tensor(x), packed)


def test_fused_mlp_stage_runs_k5_and_the_plain_walk_does_not(monkeypatch):
    """``FusedMLP.apply`` reaches the K5 op, as the JAX stage reaches its
    Pallas kernel; ``apply_plain`` never does, and a model wider than the
    JAX package's 128 lanes is walked plainly by both."""
    ws, bs = random_mlp((6, 8, 3), seed=1)
    x = torch.as_tensor(_x(10, 6, seed=0))
    calls = []
    real = tfm.fused_mlp_packed

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tfm, "fused_mlp_packed", spy)
    st = ts.FusedMLP(ws, bs)
    np.testing.assert_array_equal(st.apply(x).numpy(),
                                  st.apply_plain(x).numpy())
    assert calls == [1]
    wide = ts.FusedMLP(*random_mlp((6, 200, 3), seed=2))
    wide.apply(x)
    assert calls == [1]


def _full_stateful():
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=64)
    w, b = he_mlp((ws.n_out,) + FULL[1:], seed=0)
    return [fk, ru, ws, js.FusedMLP(w, b), js.Reduce("argmax")]


def test_full_width_classifier_is_not_declined():
    """The [30, 128 x 10, 2] classifier (611,336 B of parameters): the JAX
    package lowers it onto a kernel, and so does the port, stateless and
    in the fused stateful launch (K1's "mlp" mode, here at W = 28)."""
    w, b = he_mlp(FULL, seed=0)
    jstages = [js.FusedMLP(w, b), js.Reduce("argmax")]
    assert pallas_backend.pallas_eligible(jstages)
    tstages = convert.stages_from_reference(jstages)
    assert cuda_backend.stages_decline_reason(tstages) is None
    assert cuda_backend.stages_decline_reason(
        ts.fuse_pipeline_stages(tstages)) is None
    assert not cuda_backend.stages_in_plain_walk(tstages)
    x = torch.as_tensor(_x(40, 30, seed=5))
    comp = ts.compile_stages(tstages, backend="cuda", device="cpu")
    assert comp.backend == "cpu-ref"
    jv = np.asarray(jfm.fused_mlp_classify(
        jnp.asarray(x.numpy()), [jnp.asarray(a) for a in w],
        [jnp.asarray(a) for a in b]))
    np.testing.assert_array_equal(comp(x).numpy(), jv)
    stateful = convert.stages_from_reference(_full_stateful())
    assert cuda_backend.fused_flow_decline_reason(stateful[:2],
                                                  stateful[2:]) is None
    for fuse in (True, False):
        pipe = StatefulPipeline(stateful, backend="cuda", fuse=fuse,
                                device="cpu")
        assert pipe.backend == ("cpu-ref-fused-flow" if fuse else "cpu-ref")
