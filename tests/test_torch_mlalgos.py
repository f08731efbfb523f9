"""The port's trainers and metrics (``repro_torch.core.mlalgos``) against
the JAX package's (``repro.core.mlalgos``), on the CPU.

* f1, accuracy and v_measure: exact, the edge cases of
  ``tests/test_metrics_edge.py`` included (both are the same numpy).
* KMeans, SVM and the tree: the same seed trains the same model, exactly.
* The DNN: torch and JAX draw different random numbers, so the seam
  ``mlp_train`` is given the JAX package's initial weights and its
  minibatch schedule, replayed as ``mlalgos.py:173-176`` draws it
  (``split`` then ``randint`` per step).  After 20 Adam steps the logits
  on the test set agree within 1e-4 x (1 + |JAX|) (XLA and torch sum the
  products in other orders), and verdicts differ only on rows whose
  top-two margin is within 1e-4.
* Bucket lanes against one-lane runs, as ``tests/test_dse_parallel.py``
  holds the JAX trainer: weights within rtol 2e-5, atol 1e-6, and at most
  0.5 % of verdicts apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import mlalgos as jm
from repro.core import traincache as jtc
from repro.data import netdata as jnd
from repro_torch.core import mlalgos as tm
from repro_torch.core import traincache as ttc
from repro_torch.data import netdata as tnd
from repro_torch.testing import MARGIN, verdict_mismatches

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    j = jnd.make_ad_dataset(features=7, n_train=1024, n_test=512)
    t = tnd.make_ad_dataset(features=7, n_train=1024, n_test=512)
    for a in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(j, a), getattr(t, a))
    return j, t


# ------------------------------------------------------------------ metrics

EDGE = [
    (np.array([]), np.array([]), 2),
    (np.zeros(8, np.int32), np.zeros(8, np.int32), 2),
    (np.array([0, 0, 1, 1]), np.zeros(4, np.int32), 2),
    (np.zeros(4, np.int32), np.array([0, 0, 1, 1]), 2),
    (np.array([0, 1, 2, 0, 1, 2]), np.zeros(6, np.int32), 3),
    (np.array([0, 1, 2, 0, 1, 2]), np.array([0, 1, 2, 0, 1, 2]), 4),
    (np.array([0, 1, 1, 0, 1]), np.array([0, 1, 1, 0, 1]), 2),
]


@pytest.mark.parametrize("i", range(len(EDGE)))
def test_metric_edge_cases_exact(i):
    y_true, y_pred, c = EDGE[i]
    assert tm.f1_score(y_true, y_pred, num_classes=c) == \
        jm.f1_score(y_true, y_pred, num_classes=c)
    assert tm.accuracy(y_true, y_pred) == jm.accuracy(y_true, y_pred)
    assert tm.v_measure(y_true, y_pred) == jm.v_measure(y_true, y_pred)
    for metric in ("f1", "accuracy", "v_measure"):
        assert tm.evaluate_metric(metric, y_true, y_pred, num_classes=c) == \
            jm.evaluate_metric(metric, y_true, y_pred, num_classes=c)


@given(n=st.integers(1, 40), seed=st.integers(0, 2**31))
@settings(max_examples=25, deadline=None)
def test_metrics_exact_on_random_labels(n, seed):
    rng = np.random.default_rng(seed)
    for c in (2, 3, 5):
        y_true = rng.integers(0, c, n)
        y_pred = rng.integers(0, c, n)
        assert tm.f1_score(y_true, y_pred, num_classes=c) == \
            jm.f1_score(y_true, y_pred, num_classes=c)
        assert tm.v_measure(y_true, y_pred) == jm.v_measure(y_true, y_pred)
        assert tm.accuracy(y_true, y_pred) == jm.accuracy(y_true, y_pred)


# ----------------------------------------------------- the numpy algorithms


@pytest.mark.parametrize("k,n_feat", [(2, None), (4, 3), (6, None)])
def test_kmeans_exact(data, k, n_feat):
    j, t = data
    cfg = {"k": k} if n_feat is None else {"k": k, "n_features": n_feat}
    a = jm.train("kmeans", j, cfg, seed=3)
    b = tm.train("kmeans", t, cfg, seed=3, device="cpu")
    np.testing.assert_array_equal(a.params["centroids"], b.params["centroids"])
    np.testing.assert_array_equal(a.params["label_map"], b.params["label_map"])
    np.testing.assert_array_equal(a.predict(j.test_x), b.predict(t.test_x))
    np.testing.assert_array_equal(a.topology["assign"](j.test_x),
                                  b.topology["assign"](t.test_x))
    for key in ("k", "n_features", "feature_idx"):
        assert a.topology[key] == b.topology[key]
    assert b.topology["n_inputs"] == 7
    assert (a.param_count, a.num_classes, a.config) == \
        (b.param_count, b.num_classes, b.config)


@pytest.mark.parametrize("c_reg", [0.5, 1.0, 20.0])
def test_svm_exact(data, c_reg):
    j, t = data
    a = jm.train("svm", j, {"c_reg": c_reg}, seed=1)
    b = tm.train("svm", t, {"c_reg": c_reg}, seed=1, device="cpu")
    np.testing.assert_array_equal(a.params["W"], b.params["W"])
    np.testing.assert_array_equal(a.params["b"], b.params["b"])
    np.testing.assert_array_equal(a.predict(j.test_x), b.predict(t.test_x))
    assert a.topology == b.topology and a.param_count == b.param_count


@pytest.mark.parametrize("depth", [2, 4, 6])
def test_tree_exact(data, depth):
    j, t = data
    a = jm.train("tree", j, {"max_depth": depth}, seed=0)
    b = tm.train("tree", t, {"max_depth": depth}, seed=0, device="cpu")
    assert a.topology == b.topology
    np.testing.assert_array_equal(a.predict(j.test_x), b.predict(t.test_x))
    assert a.param_count == b.param_count


def test_numpy_pool_matches_sequential(data):
    _, t = data
    for algo, cfgs in (
        ("svm", [{"c_reg": 0.5}, {"c_reg": 2.0}]),
        ("kmeans", [{"k": 2}, {"k": 4, "n_features": 3}]),
        ("tree", [{"max_depth": 2}, {"max_depth": 3}]),
    ):
        pooled = tm.train_batch(algo, t, cfgs, seed=2, device="cpu")
        for cfg, tp in zip(cfgs, pooled):
            ts = tm.train(algo, t, cfg, seed=2, device="cpu")
            np.testing.assert_array_equal(ts.predict(t.test_x),
                                          tp.predict(t.test_x))


CONFIGS = [
    ("dnn", {"n_layers": 2, "h0": 16, "h1": 8, "h2": 64, "lr": 1e-3}),
    ("dnn", {"n_layers": 1, "h0": 8, "batch": 128, "epochs": 8}),
    ("logreg", {"lr": 0.3}),
    ("kmeans", {"k": 3, "n_features": 9}),
    ("svm", {"c_reg": 3.0}),
    ("tree", {"max_depth": 5}),
]


@pytest.mark.parametrize("algo,cfg", CONFIGS)
def test_effective_config_and_cache_key_match(data, algo, cfg):
    j, t = data
    assert tm.effective_config(algo, cfg, t) == \
        jm.effective_config(algo, cfg, j)
    assert ttc.candidate_key(algo, cfg, 4, t) == \
        jtc.candidate_key(algo, cfg, 4, j)
    # the device joins the key only when given
    assert ttc.candidate_key(algo, cfg, 4, t, device="cpu") != \
        ttc.candidate_key(algo, cfg, 4, t, device="cuda")


def test_cache_lru_and_stats(data):
    _, t = data
    cache = ttc.CandidateCache(max_entries=2)
    models = [tm.train("svm", t, {"c_reg": c}, device="cpu")
              for c in (1.0, 2.0, 3.0)]
    for i, m in enumerate(models):
        cache.put(str(i), m)
    assert len(cache) == 2 and cache.get("0") is None
    assert cache.get("2") is models[2]
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 1}


# ------------------------------------------------------------------- DNN


def _jax_schedule(seed: int, n: int, nsteps: int, batch: int) -> np.ndarray:
    """The minibatch indices ``_mlp_train_body`` draws: per step
    ``key, kb = split(key)``, ``randint(kb, (batch,), 0, n)``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(nsteps):
        key, kb = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(kb, (batch,), 0, n)))
    return np.stack(out)


@pytest.mark.parametrize("widths,lr,batch", [
    ([7, 16, 8, 2], 3e-3, 128),
    ([7, 24, 2], 1e-2, 256),
    ([7, 2], 0.1, 256),
    ([7, 32, 16, 8, 2], 1e-3, 64),
])
def test_dnn_seam_matches_jax_after_20_steps(data, widths, lr, batch):
    j, t = data
    nsteps, seed = 20, 5
    init = jm._mlp_init(jax.random.PRNGKey(seed), widths)
    want = jm._mlp_train_loop(
        init, jnp.asarray(j.train_x), jnp.asarray(j.train_y),
        jax.random.PRNGKey(seed + 1), jnp.float32(lr),
        nsteps=nsteps, batch=batch)
    idx = torch.from_numpy(_jax_schedule(seed + 1, len(j.train_x), nsteps,
                                         batch).astype(np.int64))
    params = [{"w": torch.from_numpy(np.array(l["w"]))[None],
               "b": torch.from_numpy(np.array(l["b"]))[None]}
              for l in init]
    got = tm.mlp_train(params, None, torch.from_numpy(t.train_x),
                       torch.from_numpy(t.train_y.astype(np.int64)), idx,
                       torch.tensor([lr]))
    want_logits = np.asarray(jm.mlp_forward(want, jnp.asarray(j.test_x)))
    got_logits = tm.mlp_forward(
        [{k: v[0] for k, v in l.items()} for l in got],
        torch.from_numpy(t.test_x)).numpy()
    np.testing.assert_array_less(np.abs(got_logits - want_logits),
                                 LOGIT_TOL * (1 + np.abs(want_logits)))
    bad, _ = verdict_mismatches(np.argmax(got_logits, 1), want_logits, MARGIN)
    assert bad == 0


def test_masked_lanes_never_move(data):
    """A zero-padded entry with a zero mask stays exactly zero."""
    _, t = data
    p = tm._mlp_init(torch.Generator().manual_seed(0), [7, 8, 2])
    pp, mm = tm._pad_mlp_params(p, [7, 8, 2], [7, 16, 2])
    stack = [{k: v[None] for k, v in l.items()} for l in pp]
    masks = [{k: v[None] for k, v in l.items()} for l in mm]
    idx = tm.minibatch_schedule(1, len(t.train_x), 30, 64)
    out = tm.mlp_train(stack, masks, torch.from_numpy(t.train_x),
                       torch.from_numpy(t.train_y.astype(np.int64)), idx,
                       torch.tensor([1e-2]))
    assert torch.all(out[0]["w"][0, :, 8:] == 0)
    assert torch.all(out[0]["b"][0, 8:] == 0)
    assert torch.all(out[1]["w"][0, 8:, :] == 0)
    assert not torch.equal(out[0]["w"][0, :, :8], stack[0]["w"][0, :, :8])


def test_dnn_buckets_match_sequential(data):
    _, t = data
    cfgs = [
        {"n_layers": 1, "h0": 8, "lr": 3e-3, "batch": 128, "epochs": 1},
        {"n_layers": 1, "h0": 16, "lr": 1e-3, "batch": 128, "epochs": 1},
        {"n_layers": 2, "h0": 8, "h1": 8, "lr": 2e-3, "batch": 128,
         "epochs": 1},
    ]
    batched = tm.train_batch("dnn", t, cfgs, seed=0, device="cpu")
    for cfg, tb in zip(cfgs, batched):
        ts = tm.train("dnn", t, cfg, seed=0, device="cpu")
        assert ts.topology["widths"] == tb.topology["widths"]
        assert ts.param_count == tb.param_count
        for a, b in zip(ts.params, tb.params):
            np.testing.assert_allclose(a["w"], b["w"], rtol=2e-5, atol=1e-6)
        assert np.mean(ts.predict(t.test_x) != tb.predict(t.test_x)) <= 0.005


def test_dnn_learns_like_the_reference(data):
    """Different random streams, same recipe: F1 within 0.05."""
    j, t = data
    a = jm.train_dnn(j, hidden=[16, 8], epochs=6, seed=0)
    b = tm.train_dnn(t, hidden=[16, 8], epochs=6, seed=0, device="cpu")
    fa = jm.f1_score(j.test_y, a.predict(j.test_x))
    fb = tm.f1_score(t.test_y, b.predict(t.test_x))
    assert abs(fa - fb) <= 0.05, (fa, fb)
    assert b.topology == a.topology and b.param_count == a.param_count
    np.testing.assert_array_equal(b.predict(t.test_x),
                                  np.argmax(b.scores(t.test_x), 1))


def test_logreg_is_a_dnn_without_hidden_layers(data):
    _, t = data
    m = tm.train("logreg", t, {"lr": 0.2}, seed=0, device="cpu")
    assert m.algorithm == "logreg" and m.topology["widths"] == [7, 2]
    assert m.config == {"lr": 0.2}


def test_trainer_refuses_cuda_without_a_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    _, t = data
    with pytest.raises(RuntimeError, match="cuda"):
        tm.train_dnn(t, hidden=[4], epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.train_batch("dnn", t, [{"n_layers": 1, "h0": 4}])
