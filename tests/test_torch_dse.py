"""The port's compiler end to end (``repro_torch.facade.generate``,
``core.dse``) against the JAX package's (``homunculus.generate``), on the
CPU (``device="cpu"``: the trainer in PyTorch on the CPU, the pipeline on
the kernels' plain versions).

* The quickstart program (``examples/quickstart.py``: the AD dataset at
  7 features, 4,096 / 2,048 rows, a DNN on Taurus 16 x 16 at 1 GPkt/s
  and 500 ns) at budget 6 with ``n_init`` 2 in both packages: both
  results are feasible on the same platform, and the port's F1 lies
  within 0.05 of the JAX package's.  The two frameworks draw different
  initial weights and minibatches from one seed, so the F1 differs by
  the spread of training, not by a rounding: 0.05 is the bound.  Budget
  6 is the smallest at which the search gets past its two seed anchors
  (one hidden layer of 4 or 16 units at lr 3e-4 for 8 epochs): at budget
  4 the pick is one of them, and their F1 spreads over 0.30-0.70 across
  training seeds in either package, so a bound there would measure that
  spread.
* ``evaluate_candidates`` on a fixed config list gives the JAX package's
  feasibility verdicts and reports (the topologies do not depend on the
  trained weights), and for the numpy trainers its F1 exactly.
"""

import numpy as np
import pytest

import homunculus
from homunculus.alchemy import DataLoader as JLoader
from homunculus.alchemy import Model as JModel
from homunculus.alchemy import Platforms as JPlatforms
from repro.core import dse as jdse
from repro.core.traincache import CandidateCache as JCache
from repro.data import netdata as jnd
from repro_torch import facade
from repro_torch.core import dse as tdse
from repro_torch.core.alchemy import DataLoader, Model, Platforms
from repro_torch.core.traincache import CandidateCache
from repro_torch.data import netdata as tnd

F1_BOUND = 0.05


def _loader(netdata):
    def wrapper_func():
        d = netdata.make_ad_dataset(features=7, n_train=4096, n_test=2048)
        return {"data": {"train": d.train_x, "test": d.test_x},
                "labels": {"train": d.train_y, "test": d.test_y},
                "feature_names": d.feature_names,
                "name": "anomaly_detection"}
    return wrapper_func


def _program(mods, algos=("dnn",), kind="Taurus"):
    loader_deco, model_cls, platforms, netdata = mods
    model = model_cls({"optimization_metric": ["f1"],
                       "algorithm": list(algos),
                       "name": "anomaly_detection",
                       "data_loader": loader_deco(_loader(netdata))})
    platform = getattr(platforms, kind)()
    platform.constrain(performance={"throughput": 1, "latency": 500},
                       resources={"rows": 16, "cols": 16})
    platform.schedule(model)
    return model, platform


JAX = (JLoader, JModel, JPlatforms, jnd)
PORT = (DataLoader, Model, Platforms, tnd)


@pytest.fixture(scope="module")
def quickstart():
    jm, jp = _program(JAX)
    tm, tp = _program(PORT)
    jr = homunculus.generate(jp, budget=6, n_init=2, seed=0,
                             cache=JCache())
    tr = facade.generate(tp, budget=6, n_init=2, seed=0,
                         cache=CandidateCache(), device="cpu")
    return (jm, jp, jr), (tm, tp, tr)


def test_quickstart_both_feasible_and_f1_close(quickstart):
    (jm, jp, jr), (tm, tp, tr) = quickstart
    a, b = jr["anomaly_detection"], tr["anomaly_detection"]
    assert a.algorithm == b.algorithm == "dnn"
    assert a.report.feasible and b.report.feasible
    # each package's pick is feasible on the other's platform model too
    assert tp.check("dnn", a.trained.topology).feasible
    assert jp.check("dnn", b.trained.topology).feasible
    assert abs(a.value - b.value) <= F1_BOUND, (a.value, b.value)
    assert len(a.history) == len(b.history) == 6
    assert all(y >= x for x, y in zip(b.regret, b.regret[1:]))
    assert tp.generated is tr and tr.schedule == "anomaly_detection"


def test_quickstart_pipeline_verifies_and_reports(quickstart):
    _, (tm, tp, tr) = quickstart
    r = tr["anomaly_detection"]
    data = tm.data()
    assert r.pipeline.verify(data.test_x) == 0.0
    outside, _ = r.pipeline.mismatches(data.test_x)
    assert outside == 0
    assert r.pipeline.compiled_backend == "cpu-ref"
    assert r.pipeline.source.startswith(
        "// auto-generated by homunculus :: taurus backend")
    s = r.summary()
    assert s["stages"] == ["fused_mlp", "reduce"]
    assert s["iterations"] == 6 and s["resources"]["cu"] <= 256
    assert tr.summary()["dag_resources"] == r.report.resources


@pytest.mark.parametrize("algo,configs", [
    ("dnn", [{"n_layers": 1, "h0": 4, "lr": 3e-3, "batch": 512,
              "epochs": 8},
             {"n_layers": 3, "h0": 128, "h1": 128, "h2": 128, "lr": 1e-3,
              "batch": 512, "epochs": 8},
             {"n_layers": 2, "h0": 16, "h1": 8, "batch": 512,
              "epochs": 8}]),
    ("svm", [{"c_reg": 0.5}, {"c_reg": 10.0}]),
    ("kmeans", [{"k": 2, "n_features": 3}, {"k": 6, "n_features": 7}]),
])
def test_evaluate_candidates_feasibility_matches(algo, configs):
    jm, jp = _program(JAX)
    tm, tp = _program(PORT)
    jo = jdse.evaluate_candidates(jp, algo, jm.data(), "f1", configs,
                                  cache=None)
    to = tdse.evaluate_candidates(tp, algo, tm.data(), "f1", configs,
                                  cache=None, device="cpu")
    assert [f for _, f, _ in jo] == [f for _, f, _ in to]
    for (_, _, a), (_, _, b) in zip(jo, to):
        ra, rb = a["report"], b["report"]
        assert (ra.reasons, ra.resources, ra.latency_ns) == \
            (rb.reasons, rb.resources, rb.latency_ns)
        assert a["params"] == b["params"]
    if algo != "dnn":       # numpy trainers: the same model, the same F1
        assert [v for v, _, _ in jo] == [v for v, _, _ in to]


def test_evaluate_candidates_cache_and_modes():
    tm, tp = _program(PORT)
    cache = CandidateCache()
    cfg = {"n_layers": 1, "h0": 8, "batch": 512, "epochs": 8}
    alias = dict(cfg, h1=64)                       # dead parameter
    out = tdse.evaluate_candidates(tp, "dnn", tm.data(), "f1", [cfg, alias],
                                   cache=cache, device="cpu")
    assert len(cache) == 1 and out[0][0] == out[1][0]
    again = tdse.evaluate_candidates(tp, "dnn", tm.data(), "f1", [cfg],
                                     cache=cache, device="cpu")
    assert again[0][2]["trained"] is out[0][2]["trained"]
    seq = tdse.evaluate_candidates(tp, "dnn", tm.data(), "f1", [cfg],
                                   mode="sequential", cache=None,
                                   device="cpu")
    assert seq[0][0] == pytest.approx(out[0][0], abs=5e-3)
    with pytest.raises(KeyError):
        tdse.evaluate_candidates(tp, "dnn", tm.data(), "f1", [cfg],
                                 mode="nope", cache=None, device="cpu")


def test_tofino_generate_serves_a_mat():
    tm, tp = _program(PORT, algos=("svm", "logreg"), kind="Tofino")
    tr = facade.generate(tp, budget=4, n_init=2, seed=0,
                         cache=CandidateCache(), device="cpu")
    r = tr["anomaly_detection"]
    assert r.report.feasible and r.algorithm in ("svm", "logreg")
    assert [s.kind for s in r.pipeline.stages] == \
        ["quantize", "lut_gather", "reduce", "label_map"]
    assert r.pipeline.compiled_backend == "cpu-ref"
    assert r.pipeline.verify(tm.data().test_x, max_mismatch_frac=0.03) <= 0.03
    assert "table score_f0" in r.pipeline.source


def test_generate_refuses_without_algorithms_that_fit():
    tm, tp = _program(PORT, algos=("dnn",), kind="Tofino")
    with pytest.raises(RuntimeError, match="no candidate algorithm"):
        facade.generate(tp, budget=4, n_init=2, device="cpu")


def test_chained_copies_search_once_and_split_the_platform():
    tm, tp = _program(PORT, algos=("svm",))
    tp.schedule((tm > tm) > tm)
    tr = facade.generate(tp, budget=4, n_init=2, seed=0,
                         cache=CandidateCache(), device="cpu")
    assert tr.schedule == "anomaly_detection > anomaly_detection > " \
        "anomaly_detection"
    assert tr.dag_report.resources == tr["anomaly_detection"].report.resources


def test_retrain_model_and_facade_exports():
    assert {"alchemy", "generate", "search_model", "GenerationResult",
            "compile_dag", "run_dag"} <= set(facade.__all__)
    d = tnd.make_ad_dataset(features=7, n_train=1024, n_test=512)
    p = Platforms.Taurus()
    p.constrain(resources={"rows": 16, "cols": 16})
    r = tdse.retrain_model(p, d, algorithms=["svm"], budget=4, n_init=2,
                           cache=CandidateCache(), device="cpu")
    assert r.algorithm == "svm" and r.report.feasible
    np.testing.assert_array_equal(r.pipeline(d.test_x[:50]),
                                  r.trained.predict(d.test_x[:50]))
