"""Port parity: multi-application DAGs (``core.chaining``) against the JAX
package's ``run_dag`` / ``compile_dag``.

Trained AD pipelines (``mlalgos`` + taurus codegen, as
``tests/test_pallas_backend.py``) and the JAX ``Model/Seq/Par`` DAG are
carried across by ``convert.pipelines_from_reference`` and
``convert.dag_from_reference``.  Every DAG runs through the JAX
``compile_dag`` on ``backend="pallas"`` (Pallas interpret mode) and the
port's on ``backend="cuda", device="cpu"`` (the kernels' plain
versions), with and without ``fuse_dag``, and through both ``run_dag``s.
Verdicts must be equal on every row where no MLP leaf has its top-two
logits within ``testing.MARGIN`` (1e-4), and exact where no MLP leaf
decides (the centroid and tree leaves and the gating are exact).  The
reported backends map ``pallas`` -> ``cpu-ref`` (``cuda`` on the card),
``pallas-fused-dag`` -> ``cpu-ref-fused-dag``, and ``interpret`` and
``mixed`` unchanged.

The Table-3 accounting (``dag_resources``, ``dag_stage_summary``,
``strategy_table``) runs over a JAX ``GenerationResult`` and its
``convert.result_from_reference``: resources, latency, throughput and
stage sums equal (Exact), with the identical-model dedup — a name
aliased to one result, and two results sharing one trained model and
pipeline, count once in both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import chaining as jchaining  # noqa: E402
from repro.core import codegen, mlalgos  # noqa: E402
from repro.core import feasibility as feas  # noqa: E402
from repro.core.alchemy import Model as JModel  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import alchemy, chaining  # noqa: E402
from repro_torch.testing import leaf_margin_rows  # noqa: E402


@pytest.fixture(scope="module")
def jpipes(ad_data):
    rep = feas.FeasibilityReport(True, [], {"cu": 1}, 1.0, 1e9)
    dnn = mlalgos.train_dnn(ad_data, hidden=[16, 8], epochs=2, seed=0)
    km = mlalgos.train_kmeans(ad_data, k=4, seed=0)
    svm = mlalgos.train_svm(ad_data, epochs=3, seed=0)
    tree = mlalgos.train_tree(ad_data, max_depth=4, seed=0)
    return {
        "dnn": codegen.taurus_codegen("dnn", dnn, rep),
        "km": codegen.taurus_codegen("km", km, rep),
        "svm": codegen.taurus_codegen("svm", svm, rep),
        "tree": codegen.Pipeline(
            "tree", "tofino", "tree", codegen.mat_stages(tree, ad_data.train_x),
            "", rep, tree),
    }


@pytest.fixture(scope="module")
def tpipes(jpipes):
    return convert.pipelines_from_reference(jpipes, device="cpu")


def _m(name):
    return JModel({"name": name, "data_loader": lambda: None,
                   "algorithm": None})


def _node(shape):
    if shape == "seq":
        return _m("dnn") > _m("svm")
    if shape == "par":
        return _m("dnn") | _m("svm")
    if shape == "nested":
        return _m("dnn") > (_m("svm") | _m("dnn"))
    if shape == "km":
        return _m("dnn") > _m("km")
    if shape == "tree":
        return _m("tree") > (_m("dnn") | _m("km"))
    raise KeyError(shape)


def _port_name(jname: str) -> str:
    return {"pallas": "cpu-ref",
            "pallas-fused-dag": "cpu-ref-fused-dag"}.get(jname, jname)


CASES = [("seq", "or"), ("par", "or"), ("par", "and"), ("nested", "or"),
         ("nested", "and"), ("km", "or"), ("tree", "or"), ("par", "concat")]


@pytest.mark.parametrize("shape,combine", CASES)
@pytest.mark.parametrize("fuse_dag", [True, False])
def test_compile_dag_matches_reference(jpipes, tpipes, ad_data, shape,
                                       combine, fuse_dag):
    X = ad_data.test_x[:500]
    jnode = _node(shape)
    tnode = convert.dag_from_reference(jnode)
    jdag = jchaining.compile_dag(jnode, jpipes, combine=combine,
                                 backend="pallas", fuse_dag=fuse_dag)
    tdag = chaining.compile_dag(tnode, tpipes, combine=combine,
                                backend="cuda", fuse_dag=fuse_dag,
                                device="cpu")
    assert tdag.backend == _port_name(jdag.backend)
    assert tdag.model_backends == {k: _port_name(v) for k, v
                                   in jdag.model_backends.items()}
    assert tdag.fused_dag == jdag.fused_dag
    assert (tdag.fallback_reason is None) == (tdag.fused_dag or not fuse_dag)
    jv = jdag(X)
    tv = tdag(X)
    assert tv.shape == jv.shape and tv.dtype == np.int32
    close = leaf_margin_rows([tpipes[m.name] for m in tnode.leaves()], X)
    if tv.ndim == 2:
        close = close[:, None]
    bad = int(((tv != jv) & ~close).sum())
    print(f"{shape}/{combine}: {int(close.sum())} rows within a margin")
    assert bad == 0 and close.sum() <= len(X) // 50
    # the eager references agree with their compiled forms
    np.testing.assert_array_equal(
        chaining.run_dag(tnode, tpipes, X, combine=combine), tv)
    np.testing.assert_array_equal(
        jchaining.run_dag(jnode, jpipes, X, combine=combine), jv)


@pytest.mark.parametrize("shape", ["seq", "nested", "km", "tree"])
def test_interpret_backend_matches_reference(jpipes, tpipes, ad_data,
                                             shape):
    X = ad_data.test_x[:300]
    jnode = _node(shape)
    tnode = convert.dag_from_reference(jnode)
    jdag = jchaining.compile_dag(jnode, jpipes)
    tdag = chaining.compile_dag(tnode, tpipes, device="cpu")
    assert jdag.backend == tdag.backend == "interpret"
    close = leaf_margin_rows([tpipes[m.name] for m in tnode.leaves()], X)
    assert int(((tdag(X) != jdag(X)) & ~close).sum()) == 0
    assert tdag.with_backend("cuda").backend == _port_name(
        jdag.with_backend("pallas").backend)


def test_tree_leaf_is_exact(jpipes, tpipes, ad_data):
    """TreeTraverse (compare and gather, no sums) matches bit for bit."""
    X = ad_data.test_x
    jv = np.asarray(jpipes["tree"](X))
    tv = tpipes["tree"](X)
    np.testing.assert_array_equal(tv, jv)


def test_dag_vocabulary():
    a, b, c = (alchemy.Model(n) for n in "abc")
    seq = (a > b) > c
    assert [m.name for m in seq.leaves()] == ["a", "b", "c"]
    assert seq.describe() == "a > b > c"
    par = (a | b) | c
    assert len(par.children) == 3 and par.describe() == "a | b | c"
    nested = a > (b | c)
    assert nested.describe() == "a > (b | c)"
    with pytest.raises(TypeError, match="parentheses"):
        a > b > c                                    # noqa: B015
    with pytest.raises(TypeError):
        a > 3
    jnode = _m("x") > (_m("y") | _m("x"))
    tnode = convert.dag_from_reference(jnode)
    assert tnode.describe() == jnode.describe()
    assert [m.name for m in tnode.leaves()] == ["x", "y", "x"]


def test_compile_dag_rejects_unknown_options(tpipes):
    node = alchemy.Model("dnn") > alchemy.Model("svm")
    with pytest.raises(KeyError):
        chaining.compile_dag(node, tpipes, backend="pallas", device="cpu")
    with pytest.raises(KeyError):
        chaining.compile_dag(node, tpipes, combine="xor", device="cpu")
    with pytest.raises(KeyError):
        chaining.run_dag(node, tpipes, np.zeros((2, 7)), combine="xor")


# ------------------------------------------------------------ accounting


@pytest.fixture(scope="module")
def jresult(jpipes):
    """A JAX ``GenerationResult`` on Taurus 16 x 16: "dnn" and "svm" with
    their own reports, "dnn_copy" the same ``ModelResult`` as "dnn" (as
    ``generate`` aliases chained copies), "dnn_twin" another result
    sharing the DNN's trained model and pipeline, and "km"."""
    from homunculus.alchemy import Platforms as JPlatforms
    from repro.core import dse as jdse

    p = JPlatforms.Taurus()
    p.constrain(resources={"rows": 16, "cols": 16})

    def result(name, pipe, value):
        tm = pipe.model
        return jdse.ModelResult(
            name=name, algorithm=tm.algorithm, trained=tm, pipeline=pipe,
            report=p.check(tm.algorithm, tm.topology), value=value,
            metric="f1", history=[], regret=[value], wall_s=0.5)

    models = {"dnn": result("dnn", jpipes["dnn"], 0.8),
              "svm": result("svm", jpipes["svm"], 0.7),
              "km": result("km", jpipes["km"], 0.6)}
    models["dnn_copy"] = models["dnn"]
    twin = result("dnn_twin", jpipes["dnn"], 0.8)
    twin.report = models["dnn"].report
    models["dnn_twin"] = twin
    return jdse.GenerationResult(p.kind, models, None, "dnn > svm")


def _strategies(model):
    return {"seq": model("dnn") > model("svm"),
            "copies": (model("dnn") > model("dnn_copy")) > model("dnn"),
            "twin": model("dnn") | model("dnn_twin"),
            "mixed": (model("dnn") > (model("svm") | model("dnn_copy")))
            > model("km"),
            "one": model("svm")}


def test_result_from_reference_keeps_sharing(jresult):
    tr = convert.result_from_reference(jresult, device="cpu")
    assert set(tr.models) == set(jresult.models)
    assert tr["dnn_copy"] is tr["dnn"]
    assert tr["dnn_twin"] is not tr["dnn"]
    assert tr["dnn_twin"].trained is tr["dnn"].trained
    assert tr["dnn_twin"].pipeline is tr["dnn"].pipeline
    for name, r in jresult.models.items():
        t = tr[name]
        assert t.report.resources == r.report.resources
        assert t.report.latency_ns == r.report.latency_ns
        assert t.trained.param_count == r.trained.param_count
        assert t.pipeline.stage_summary() == r.pipeline.stage_summary()
        assert t.summary() == r.summary()


def test_accounting_matches_reference(jresult):
    tr = convert.result_from_reference(jresult, device="cpu")
    js, ts = _strategies(_m), _strategies(alchemy.Model)
    for k in js:
        a = jchaining.dag_resources(js[k], jresult)
        b = chaining.dag_resources(ts[k], tr)
        assert (b.feasible, b.reasons, b.resources, b.latency_ns,
                b.throughput_pps) == (a.feasible, a.reasons, a.resources,
                                      a.latency_ns, a.throughput_pps), k
        assert chaining.dag_stage_summary(ts[k], tr) == \
            jchaining.dag_stage_summary(js[k], jresult), k
    assert chaining.strategy_table(ts, tr) == \
        jchaining.strategy_table(js, jresult)
    # the dedup: copies and a shared trained model count once
    one = chaining.dag_resources(alchemy.Model("dnn"), tr).resources
    for k in ("copies", "twin"):
        assert chaining.dag_resources(ts[k], tr).resources == one
    assert chaining.dag_stage_summary(ts["copies"], tr)["params"] == \
        tr["dnn"].trained.param_count


def test_accounting_over_bare_pipelines(tpipes):
    """``dag_stage_summary`` reads a ``{name: pipeline}`` result too
    (``tests/test_stageir_chaining.py:343``)."""
    from repro_torch.core import stageir

    a = alchemy.Model("dnn")
    s = chaining.dag_stage_summary((a > a) > a, tpipes)
    assert s == stageir.stage_summary(tpipes["dnn"].stages)
    with pytest.raises(ValueError):
        chaining.dag_resources(alchemy.Par([]), {})
