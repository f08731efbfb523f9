"""Port parity: model fusion (``core.fusion``, paper §3.2.5 and Table 4)
against the JAX package's, on the CPU.

* A JAX-trained ``FusedModel`` carried across by
  ``convert.fused_from_reference``: ``param_count``, ``topology``,
  ``fused_topology`` and each task's stage list and ``stage_summary``
  are equal; ``predict`` equals the JAX ``predict`` under the margin
  rule (a row may differ only where the task's top-two logits lie within
  ``testing.MARGIN`` = 1e-4: XLA on the CPU and PyTorch sum in other
  orders); each task's pipeline, served through ``PacketServeEngine`` on
  the CPU (``exec_backend="interpret"``, and ``"cuda"``, which takes
  K3's plain version there), gives the same verdicts under the same
  rule, and ``verify`` holds.
* The trainer: given the JAX package's initial weights and its
  minibatch schedule (drawn here as ``_fused_train`` draws it), the
  port's ``_fused_train`` ends within 1e-6 of the JAX one's weights
  after 40 Adam steps (f32 sums in other orders).
* ``fuse(device="cpu")`` at ``tests/test_alchemy_dse.py:166-168``'s size
  (the AD data at 7 features, 2,048 / 1,024 rows, split in halves,
  hidden [24, 16], 6 epochs) on the JAX package's own datasets: each
  task's F1 within 0.05 of the JAX ``fuse``'s, and the fused CU under
  0.7 x two separate models' under ``TaurusModel``.  The two frameworks
  draw different initial weights and minibatches from one seed, so the
  F1 differs by the spread of training: 0.05 is the bound the
  compiler's CPU test uses.  At this size one seed's F1 spreads with a
  standard deviation of 0.04-0.05 in the JAX package itself (0.61-0.75
  over seeds 0-3), so the bound is held on the mean over
  ``F1_SEEDS`` = 12 seeds of each package (standard error about 0.013).
* ``feature_overlap`` / ``should_fuse`` equal the JAX functions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fusion as jfusion  # noqa: E402
from repro.core.feasibility import TaurusModel as JTaurus  # noqa: E402
from repro.data import netdata as jnd  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import fusion  # noqa: E402
from repro_torch.core.feasibility import TaurusModel  # noqa: E402
from repro_torch.serve import PacketServeEngine  # noqa: E402
from repro_torch.testing import MARGIN  # noqa: E402

F1_BOUND = 0.05
F1_SEEDS = 12


@pytest.fixture(scope="module")
def halves():
    d = jnd.make_ad_dataset(features=7, n_train=2048, n_test=1024)
    return d.split_half()


@pytest.fixture(scope="module")
def jfused(halves):
    return jfusion.fuse(list(halves), hidden=[24, 16], epochs=6)


@pytest.fixture(scope="module")
def tfused(jfused):
    return convert.fused_from_reference(jfused, device="cpu")


def _jax_logits(jf, task, X):
    import jax.numpy as jnp

    return np.asarray(jfusion._fused_forward(
        jf.params, jnp.asarray(X, jnp.float32))[task])


def _outside_margin(got, want, logits) -> int:
    top = np.sort(np.asarray(logits, np.float64), 1)
    near = top[:, -1] - top[:, -2] <= MARGIN
    return int(((np.asarray(got) != np.asarray(want)) & ~near).sum())


def test_overlap_and_should_fuse_match_reference(halves):
    d = jnd.make_ad_dataset(features=7, n_train=256, n_test=128)
    sub = d.subset_features([0, 1, 2])
    a, b = halves
    for x, y in ((a, b), (d, sub), (sub, d)):
        tx, ty = convert.dataset_from_reference(x), \
            convert.dataset_from_reference(y)
        assert fusion.feature_overlap(tx, ty) == jfusion.feature_overlap(x, y)
        assert fusion.should_fuse(tx, ty) == jfusion.should_fuse(x, y)
    assert fusion.FUSE_OVERLAP_THRESHOLD == jfusion.FUSE_OVERLAP_THRESHOLD


def test_structure_matches_reference(jfused, tfused):
    assert tfused.param_count == jfused.param_count
    assert tfused.fused_topology() == jfused.fused_topology()
    for t in range(len(jfused.heads)):
        assert tfused.topology(t) == jfused.topology(t)
        js, ts = jfused.task_stages(t), tfused.task_stages(t)
        assert [s.kind for s in ts] == [s.kind for s in js]
        for a, b in zip(js[0].weights + js[0].biases,
                        ts[0].weights + ts[0].biases):
            assert np.array_equal(np.asarray(a), b)
        jp = jfused.task_pipeline(t)
        tp = tfused.task_pipeline(t, exec_backend="interpret")
        assert tp.stage_summary() == jp.stage_summary()
        assert tp.model.param_count == jp.model.param_count \
            == tp.stage_summary()["params"]
        assert tp.source == jp.source


@pytest.mark.parametrize("task", [0, 1])
def test_predict_matches_reference_under_the_margin_rule(jfused, tfused,
                                                         task):
    X = jfused.datasets[task].test_x
    logits = _jax_logits(jfused, task, X)
    assert _outside_margin(tfused.predict(task, X),
                           jfused.predict(task, X), logits) == 0
    np.testing.assert_allclose(tfused.logits(task, X), logits, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("task", [0, 1])
@pytest.mark.parametrize("exec_backend", ["interpret", "cuda"])
def test_task_pipelines_serve_the_same_verdicts(jfused, tfused, task,
                                                exec_backend):
    X = jfused.datasets[task].test_x
    want = jfused.predict(task, X)
    logits = _jax_logits(jfused, task, X)
    pipe = tfused.task_pipeline(task, exec_backend=exec_backend)
    assert pipe.compiled_backend == ("interpret" if exec_backend ==
                                     "interpret" else "cpu-ref")
    eng = PacketServeEngine(pipe, feature_dim=X.shape[1], max_batch=256,
                            device="cpu")
    eng.submit(X)
    served = eng.flush()
    assert len(served) == len(X)
    assert _outside_margin(served, want, logits) == 0
    assert _outside_margin(pipe(X), want, logits) == 0
    assert pipe.verify(X) == 0.0


def test_fused_train_matches_reference_given_its_draws(halves):
    import jax
    import jax.numpy as jnp

    widths, batch, nsteps = [7, 24, 16], 256, 40
    key = jax.random.PRNGKey(0)
    layers = []
    for n_in, n_out in zip(widths + [16, 16], widths[1:] + [2, 2]):
        key, k = jax.random.split(key)
        layers.append({"w": jax.random.normal(k, (n_in, n_out))
                       * np.sqrt(2.0 / n_in), "b": jnp.zeros((n_out,))})
    params = {"trunk": layers[:2], "heads": layers[2:]}
    xs = np.concatenate([h.train_x for h in halves])
    N = len(xs)
    ys = np.zeros((N, 2), np.int32)
    masks = np.zeros((N, 2), np.float32)
    ys[:len(halves[0].train_x), 0] = halves[0].train_y
    ys[len(halves[0].train_x):, 1] = halves[1].train_y
    masks[:len(halves[0].train_x), 0] = 1.0
    masks[len(halves[0].train_x):, 1] = 1.0
    want = jfusion._fused_train(
        params, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(masks),
        jax.random.PRNGKey(1), jnp.float32(3e-3), nsteps=nsteps,
        batch=batch)
    k, idx = jax.random.PRNGKey(1), []
    for _ in range(nsteps):
        k, kb = jax.random.split(k)
        idx.append(np.asarray(jax.random.randint(kb, (batch,), 0, N)))
    got = fusion._fused_train(
        {part: [{n: torch.as_tensor(np.array(v)) for n, v in l.items()}
                for l in ls] for part, ls in params.items()},
        torch.as_tensor(xs), torch.as_tensor(ys).long(),
        torch.as_tensor(masks), torch.as_tensor(np.stack(idx)).long(),
        3e-3)
    for part in ("trunk", "heads"):
        for a, b in zip(want[part], got[part]):
            for n in ("w", "b"):
                np.testing.assert_allclose(b[n].numpy(), np.asarray(a[n]),
                                           rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def f1_by_seed(halves):
    """[seed, task] F1 of the JAX ``fuse`` and the port's, seeds 0 ..
    F1_SEEDS - 1."""
    parts = [convert.dataset_from_reference(h) for h in halves]
    j, t = [], []
    for seed in range(F1_SEEDS):
        jf = jfusion.fuse(list(halves), hidden=[24, 16], epochs=6, seed=seed)
        tf = fusion.fuse(parts, hidden=[24, 16], epochs=6, seed=seed,
                         device="cpu")
        j.append([jf.f1(k) for k in (0, 1)])
        t.append([tf.f1(k) for k in (0, 1)])
    return np.asarray(j), np.asarray(t)


@pytest.mark.parametrize("task", [0, 1])
def test_fuse_f1_within_bound_of_reference(f1_by_seed, task):
    j, t = f1_by_seed
    assert abs(t[:, task].mean() - j[:, task].mean()) <= F1_BOUND, (t, j)
    assert t[:, task].mean() > 0.6


@pytest.fixture(scope="module")
def trained_on_cpu(halves):
    parts = [convert.dataset_from_reference(h) for h in halves]
    return fusion.fuse(parts, hidden=[24, 16], epochs=6, device="cpu")


def test_fuse_keeps_table4_resources(trained_on_cpu, jfused):
    """Paper Table 4: the fused topology takes under 0.7x the CU of two
    separate models, in both packages' Taurus models."""
    fused = trained_on_cpu
    sep = {"widths": [7, 24, 16, 2], "act": "relu"}
    for tm, f in ((TaurusModel(), fused), (JTaurus(), jfused)):
        fused_cu = tm.estimate("dnn", f.fused_topology())["options"][0]["cu"]
        sep_cu = 2 * tm.estimate("dnn", sep)["options"][0]["cu"]
        assert fused_cu < 0.7 * sep_cu
    assert fused.fused_topology() == jfused.fused_topology()
    assert fused.param_count == jfused.param_count
    assert abs(fused.f1(0) - fused.f1(1)) < 0.1


def test_fuse_is_seeded_and_refuses_misaligned_data(halves):
    parts = [convert.dataset_from_reference(h) for h in halves]
    a = fusion.fuse(parts, hidden=[8], epochs=1, device="cpu", seed=3)
    b = fusion.fuse(parts, hidden=[8], epochs=1, device="cpu", seed=3)
    for part in ("trunk", "heads"):
        for la, lb in zip(a.params[part], b.params[part]):
            assert np.array_equal(la["w"], lb["w"])
    with pytest.raises(ValueError, match="two"):
        fusion.fuse(parts[:1], device="cpu")
    sub = convert.dataset_from_reference(
        halves[1].subset_features([0, 1, 2]))
    with pytest.raises(ValueError, match="feature-aligned"):
        fusion.fuse([parts[0], sub], device="cpu")
