"""Port parity: the whole-DAG kernel's function (K6, ``fused_dag``) and
its lowering.

Trained AD pipelines (``mlalgos.train_dnn/svm/kmeans`` + taurus codegen,
as the fixture of ``tests/test_pallas_backend.py``) are carried across
by ``convert.pipelines_from_reference``.  The port's plain K6 version
(``kernels.fused_mlp.fused_dag`` on CPU tensors, the postfix program the
kernel runs) is held against the JAX ``fused_dag`` (Pallas, interpret
mode) and ``fused_dag_reference``.  Verdicts must be equal on every row
where no MLP leaf has its top-two logits within ``testing.MARGIN``
(1e-4; a Seq gate carries one leaf's flip downstream), and the test
counts the excluded rows.  The plan fold (``eval_dag_plan``) and its
encoding are exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import codegen, mlalgos, pallas_backend  # noqa: E402
from repro.core import feasibility as feas  # noqa: E402
from repro.core import stageir as js  # noqa: E402
from repro.core.alchemy import Model as JModel  # noqa: E402
from repro.kernels import fused_mlp as jfm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import cuda_backend  # noqa: E402
from repro_torch.core import stageir as ts  # noqa: E402
from repro_torch.kernels import fused_mlp as tfm  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    AD_FULL_WIDTHS,
    he_mlp,
    leaf_margin_rows,
)


@pytest.fixture(scope="module")
def jpipes(ad_data):
    rep = feas.FeasibilityReport(True, [], {"cu": 1}, 1.0, 1e9)
    dnn = mlalgos.train_dnn(ad_data, hidden=[16, 8], epochs=2, seed=0)
    km = mlalgos.train_kmeans(ad_data, k=4, seed=0)
    svm = mlalgos.train_svm(ad_data, epochs=3, seed=0)
    return {
        "dnn": codegen.taurus_codegen("dnn", dnn, rep),
        "km": codegen.taurus_codegen("km", km, rep),
        "svm": codegen.taurus_codegen("svm", svm, rep),
    }


@pytest.fixture(scope="module")
def tpipes(jpipes):
    return convert.pipelines_from_reference(jpipes, device="cpu")


def _jleaf(name):
    return JModel({"name": name, "data_loader": lambda: None,
                   "algorithm": None})


def _jnodes():
    d, s = _jleaf("dnn"), _jleaf("svm")
    nested = _jleaf("dnn") > (_jleaf("svm") | _jleaf("dnn"))
    return {"seq": d > s, "par": _jleaf("dnn") | _jleaf("svm"),
            "nested": nested,
            "three": (_jleaf("svm") > _jleaf("dnn")) > _jleaf("svm")}


@pytest.mark.parametrize("shape", ["seq", "par", "nested", "three"])
@pytest.mark.parametrize("combine", ["or", "and"])
def test_plain_k6_matches_pallas_fused_dag(jpipes, tpipes, ad_data, shape,
                                           combine):
    jnode = _jnodes()[shape]
    tnode = convert.dag_from_reference(jnode)
    X = ad_data.test_x[:600]
    jplan, jmodels = pallas_backend._plan_dag(jnode, jpipes, combine, True)
    jfn = pallas_backend.lower_dag_pallas(jnode, jpipes, combine=combine)
    assert jfn is not None
    jv = np.asarray(jfn(jnp.asarray(X)))
    jref = np.asarray(jfm.fused_dag_reference(
        jnp.asarray(X), [(w, b) for _, w, b in jmodels], jplan))
    np.testing.assert_array_equal(jv, jref)

    plan, models, reason = cuda_backend._prepare_dag(tnode, tpipes, combine,
                                                     True)
    assert reason is None and plan == jplan
    assert len(models) == len(jmodels)
    tv = cuda_backend.lower_dag_cuda(tnode, tpipes, "cpu",
                                     combine=combine)(torch.as_tensor(X))
    tref = tfm.fused_dag_ref(
        torch.as_tensor(X),
        [([torch.as_tensor(w) for w in ws], [torch.as_tensor(b) for b in bs])
         for ws, bs in models], tfm.encode_plan(plan))
    np.testing.assert_array_equal(tv.numpy(), tref.numpy())
    close = leaf_margin_rows(tpipes.values(), X)
    bad = int(((tv.numpy() != jv) & ~close).sum())
    print(f"{shape}/{combine}: {int(close.sum())} of {len(X)} rows within "
          "a leaf's margin")
    assert bad == 0 and close.sum() <= len(X) // 50
    assert tv.dtype == torch.int32


def test_eval_dag_plan_matches_reference_exactly():
    rng = np.random.default_rng(3)
    plans = [("seq", (("model", 0), ("model", 1))),
             ("or", (("model", 0), ("model", 1), ("model", 2))),
             ("and", (("model", 2), ("model", 0))),
             ("seq", (("model", 0), ("or", (("model", 1), ("model", 2))),
                      ("and", (("model", 2), ("model", 0)))))]
    v = [rng.integers(-1, 4, size=500).astype(np.int32) for _ in range(3)]
    for plan in plans:
        want = np.asarray(jfm.eval_dag_plan(plan, [jnp.asarray(a)
                                                   for a in v]))
        tv = [torch.as_tensor(a) for a in v]
        got = tfm.eval_dag_plan(plan, tv)
        np.testing.assert_array_equal(got.numpy(), want)
        prog = tfm.encode_plan(plan)
        assert tfm.decode_plan(prog) == plan
        np.testing.assert_array_equal(tfm.eval_dag_program(prog, tv).numpy(),
                                      want)


def test_plan_encoding_is_postfix_and_checked():
    plan = ("seq", (("model", 0), ("or", (("model", 1), ("model", 0)))))
    assert tfm.encode_plan(plan) == ((0, 0), (0, 1), (0, 0), (2, 2), (1, 2))
    for bad in (((1, 2),), ((0, 0), (0, 1)), ((0, 0), (7, 1))):
        with pytest.raises(ValueError):
            tfm.decode_plan(bad)
    with pytest.raises(KeyError):
        tfm.encode_plan(("xor", (("model", 0),)))
    widths = [(7, 2)] * 2
    assert tfm.dag_envelope_reason(widths, plan) is None
    assert "names a model" in tfm.dag_envelope_reason(
        widths, ("seq", (("model", 0), ("model", 2))))
    assert "distinct models" in tfm.dag_envelope_reason(
        [(7, 2)] * 9, ("model", 0))
    deep = ("or", tuple(("model", i % 2) for i in range(40)))
    assert "instructions" in tfm.dag_envelope_reason(widths, deep)
    assert "input width" in tfm.dag_envelope_reason([(7, 2), (6, 2)], plan)


def _pseudo(stages):
    class _P:                            # minimal reference pipeline
        def __init__(self, s):
            self.stages = s

        def __call__(self, x):
            return np.asarray(js.apply_stages(self.stages,
                                              jnp.asarray(x, jnp.float32)))

    return _P(stages)


def test_feature_select_fold_matches_reference(ad_data):
    rng = np.random.default_rng(5)
    X = ad_data.test_x[:300]
    w_full = rng.normal(size=(7, 2)).astype(np.float32)
    b = np.zeros(2, np.float32)
    idx = np.array([1, 3, 6], np.int32)
    jp = {"a": _pseudo([js.Dense(w_full, b), js.Reduce("argmax")]),
          "b": _pseudo([js.FeatureSelect(idx), js.Dense(w_full[idx], b),
                        js.Reduce("argmax")]),
          "c": _pseudo([js.FeatureSelect(np.array([3, 1, 6], np.int32)),
                        js.Dense(w_full[[3, 1, 6]], b),
                        js.Reduce("argmax")])}
    tp = convert.pipelines_from_reference(jp, device="cpu")
    tsel = ts.FeatureSelect(idx)
    folded = cuda_backend._fold_feature_select([tsel], w_full[idx], 7)
    want = pallas_backend._fold_feature_select(
        [js.FeatureSelect(idx)], w_full[idx], 7)
    np.testing.assert_array_equal(folded, want)
    assert cuda_backend._fold_feature_select(
        [ts.FeatureSelect(np.array([3, 1, 6]))], w_full[idx], 7) is None
    for leaf, fused in (("b", True), ("c", False)):
        jnode = _jleaf("a") > _jleaf(leaf)
        tnode = convert.dag_from_reference(jnode)
        assert pallas_backend.dag_eligible(jnode, jp) is fused
        assert cuda_backend.dag_eligible(tnode, tp) is fused
        if fused:
            got = cuda_backend.lower_dag_cuda(tnode, tp, "cpu")(
                torch.as_tensor(X)).numpy()
            jv = np.asarray(pallas_backend.lower_dag_pallas(jnode, jp)(
                jnp.asarray(X)))
            close = leaf_margin_rows(tp.values(), X)
            assert int(((got != jv) & ~close).sum()) == 0
        else:
            assert "FeatureSelect" in cuda_backend.dag_decline_reason(
                tnode, tp)


def test_repeated_model_is_one_model(jpipes, tpipes):
    jnode = _jleaf("dnn") > (_jleaf("svm") | _jleaf("dnn"))
    tnode = convert.dag_from_reference(jnode)
    again = convert.pipelines_from_reference(
        {"x": jpipes["dnn"], "y": jpipes["dnn"]}, device="cpu")
    assert again["x"] is again["y"]
    _, models, _ = cuda_backend._prepare_dag(tnode, tpipes, "or", True)
    _, jmodels = pallas_backend._plan_dag(jnode, jpipes, "or", True)
    assert len(models) == len(jmodels) == 2
    plan, *_ = cuda_backend._prepare_dag(tnode, tpipes, "or", True)
    dag = tfm.pack_dag(models, plan)
    assert dag.n_models == 2
    n_dnn = sum(w.size for w in jpipes["dnn"].stages[0].weights)
    n_svm = jpipes["svm"].stages[0].w.size
    assert dag.w_flat.numel() == n_dnn + n_svm


def test_port_accepts_every_dag_the_reference_fuses(jpipes, tpipes):
    nodes = dict(_jnodes())
    nodes["km"] = _jleaf("dnn") > _jleaf("km")
    nodes["bare"] = _jleaf("dnn")
    for name, jnode in nodes.items():
        tnode = convert.dag_from_reference(jnode)
        for combine in ("or", "and", "concat"):
            want = pallas_backend.dag_eligible(jnode, jpipes,
                                               combine=combine)
            got = cuda_backend.dag_eligible(tnode, tpipes, combine=combine)
            assert got == want, (name, combine)
            if not got:
                assert cuda_backend.dag_decline_reason(
                    tnode, tpipes, combine=combine)


def test_full_width_dag_is_eligible():
    """The design space's deepest DNN, [30, 128 x 10, 2] and [7, 128 x
    10, 2], fuses into one K6 launch as the JAX package fuses it."""
    for widths in ((30,) + (128,) * 10 + (2,), AD_FULL_WIDTHS):
        w, b = he_mlp(widths, seed=0)
        sw, sb = he_mlp((widths[0], 2), seed=1)
        jp = {"deep": _pseudo([js.FusedMLP(w, b), js.Reduce("argmax")]),
              "svm": _pseudo([js.Dense(sw[0], sb[0]), js.Reduce("argmax")])}
        tp = convert.pipelines_from_reference(jp, device="cpu")
        jnode = _jleaf("deep") > _jleaf("svm")
        assert pallas_backend.dag_eligible(jnode, jp)
        tnode = convert.dag_from_reference(jnode)
        assert cuda_backend.dag_decline_reason(tnode, tp) is None
    X = np.random.default_rng(0).normal(size=(64, 7)).astype(np.float32)
    got = cuda_backend.lower_dag_cuda(tnode, tp, "cpu")(torch.as_tensor(X))
    assert got.shape == (64,) and got.dtype == torch.int32
