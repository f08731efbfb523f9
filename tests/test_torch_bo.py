"""The port's copies of the design space, the random-forest surrogate and
the constrained BO (``repro_torch.core.designspace``, ``surrogate``,
``bo``) against the JAX package's, on a numpy objective: the same seeds
give the same samples, encodings, forests, predictions and suggestion
sequences, exactly (no tolerance: both are the same numpy)."""

import numpy as np
import pytest

from repro.core import bo as jbo
from repro.core import designspace as jds
from repro.core import surrogate as jsur
from repro_torch.core import bo as tbo
from repro_torch.core import designspace as tds
from repro_torch.core import surrogate as tsur

SPACES = [("dnn", 7, 2, 64), ("dnn", 30, 3, 128), ("kmeans", 7, 2, 64),
          ("svm", 5, 4, 64), ("tree", 7, 2, 64), ("logreg", 7, 2, 64)]


@pytest.mark.parametrize("algo,f,c,mn", SPACES)
def test_space_samples_and_encodings(algo, f, c, mn):
    js = jds.algorithm_space(algo, n_features=f, num_classes=c,
                             max_neurons=mn)
    ts = tds.algorithm_space(algo, n_features=f, num_classes=c,
                             max_neurons=mn)
    assert js.names == ts.names
    assert js.size_estimate() == ts.size_estimate()
    a = js.sample_n(np.random.default_rng(3), 40)
    b = ts.sample_n(np.random.default_rng(3), 40)
    assert a == b
    np.testing.assert_array_equal(js.encode_batch(a), ts.encode_batch(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_predictions(seed):
    rng = np.random.default_rng(seed)
    X = rng.random((60, 4))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * rng.normal(size=60)
    Xq = rng.random((25, 4))
    ja = jsur.RandomForest(seed=seed, n_trees=8).fit(X, y)
    ta = tsur.RandomForest(seed=seed, n_trees=8).fit(X, y)
    for got, want in zip(ta.predict(Xq), ja.predict(Xq)):
        np.testing.assert_array_equal(got, want)
    yb = (y > np.median(y)).astype(float)
    np.testing.assert_array_equal(
        tsur.RandomForest(seed=seed).fit(X, yb).predict_proba(Xq),
        jsur.RandomForest(seed=seed).fit(X, yb).predict_proba(Xq))


def test_expected_improvement_and_erf():
    mu = np.linspace(-2, 2, 17)
    sigma = np.linspace(0.1, 1.5, 17)
    np.testing.assert_array_equal(tbo.expected_improvement(mu, sigma, 0.3),
                                  jbo.expected_improvement(mu, sigma, 0.3))
    np.testing.assert_array_equal(tbo._erf(mu), jbo._erf(mu))


def _objective(cfg):
    x, y = cfg["x"], cfg["y"]
    value = -((x - 0.7) ** 2) - 0.5 * (y - 0.2) ** 2
    return value, x + y < 1.3, {}


def _space(mod):
    return mod.DesignSpace([mod.Param("x", "real", 0.0, 1.0),
                            mod.Param("y", "real", 1e-3, 1.0, log=True),
                            mod.Param("n", "ordinal", values=(1, 2, 4))])


@pytest.mark.parametrize("seed", [0, 7])
def test_sequential_suggestions(seed):
    runs = []
    for mod, ds in ((jbo, jds), (tbo, tds)):
        opt = mod.ConstrainedBO(_space(ds), n_init=5, seed=seed,
                                candidates_per_iter=64,
                                rf_kwargs={"n_trees": 6})
        opt.run(_objective, 12)
        runs.append(opt)
    ja, tb = runs
    assert [o.config for o in ja.history] == [o.config for o in tb.history]
    assert ja.regret_curve() == tb.regret_curve()
    assert ja.best.config == tb.best.config


@pytest.mark.parametrize("seed", [0, 3])
def test_batched_suggestions(seed):
    runs = []
    for mod, ds in ((jbo, jds), (tbo, tds)):
        opt = mod.ConstrainedBO(_space(ds), n_init=4, seed=seed,
                                candidates_per_iter=48,
                                rf_kwargs={"n_trees": 6})
        opt.run_batched(lambda cfgs: [_objective(c) for c in cfgs], 14,
                        batch_size=4)
        runs.append(opt)
    ja, tb = runs
    assert [o.config for o in ja.history] == [o.config for o in tb.history]
    assert [o.feasible for o in ja.history] == \
        [o.feasible for o in tb.history]
    assert ja.best.config == tb.best.config
