"""The port's accounting, feasibility models, codegen and ``Pipeline``
(``repro_torch.core.stageir``'s specs, ``feasibility``, ``codegen``,
``alchemy``'s platforms) against the JAX package's, on the CPU.

* Stage specs, Taurus / MAT / FPGA estimates, platform verdicts and the
  flow-state and mitigation reports are equal on a grid of topologies.
  One exception, by design: a kmeans MAT charges every input feature's
  LUT (``n_inputs x 512 x k`` entries), where the JAX lowering charges
  only the features the centroids use; that charge is asserted.
* For models the JAX package trained, carried across by
  ``convert.trained_from_reference``, the stage lists equal the JAX
  stages (through ``convert.stages_from_reference``) field for field and
  the Spatial / P4 source is byte-identical.
* ``Pipeline.verify`` finds no mismatch outside the margin rule (the top
  two scores within 1e-4) on the Taurus forms; a MAT pipeline's verdicts
  equal the JAX MAT pipeline's exactly (both quantize the same way), so
  its quantization mismatch is the JAX package's (<= 0.03).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import alchemy as jal
from repro.core import codegen as jcg
from repro.core import feasibility as jfe
from repro.core import mlalgos as jm
from repro.core import stageir as jst
from repro.data import netdata as jnd
from repro.flowstate.mitigation import MitigationSpec as JMitSpec
from repro.flowstate.registers import FlowStateSpec as JSpec
from repro_torch import convert
from repro_torch.core import alchemy as tal
from repro_torch.core import codegen as tcg
from repro_torch.core import feasibility as tfe
from repro_torch.core import stageir as tst
from repro_torch.flowstate.mitigation import MitigationSpec as TMitSpec
from repro_torch.flowstate.registers import FlowStateSpec as TSpec

TOPOLOGIES = [
    ("dnn", {"widths": [7, 16, 8, 2]}),
    ("dnn", {"widths": [30, 64, 64, 64, 5]}),
    ("dnn", {"widths": [7] + [128] * 10 + [2]}),
    ("dnn", {"widths": [7, 300, 2]}),
    ("logreg", {"widths": [7, 2]}),
    ("logreg", {"widths": [40, 3]}),
    ("svm", {"n_features": 7, "n_classes": 2}),
    ("svm", {"n_features": 30, "n_classes": 6}),
    ("kmeans", {"k": 3, "n_features": 7}),
    ("kmeans", {"k": 9, "n_features": 2}),
    ("tree", {"nodes": [{}] * 31, "depth": 4}),
    ("tree", {"nodes": [{}] * 9, "depth": 10}),
]


def _fields(specs):
    return [dataclasses.astuple(s) for s in specs]


@pytest.mark.parametrize("algo,topo", TOPOLOGIES)
def test_stage_specs_and_estimates_match(algo, topo):
    dense_j = jst.lower_topology(algo, topo, form="dense")
    dense_t = tst.lower_topology(algo, topo, form="dense")
    assert _fields(dense_j) == _fields(dense_t)
    assert jst.spec_layers(dense_j) == tst.spec_layers(dense_t)
    assert jst.spec_params(dense_j) == tst.spec_params(dense_t)
    assert jfe.TaurusModel().estimate(algo, topo) == \
        tfe.TaurusModel().estimate(algo, topo)
    assert jfe.FPGAModel().estimate(algo, topo) == \
        tfe.FPGAModel().estimate(algo, topo)
    if algo != "kmeans":
        assert _fields(jst.lower_topology(algo, topo, form="mat")) == \
            _fields(tst.lower_topology(algo, topo, form="mat"))
    assert jfe.MATModel().mats_for(algo, topo) == \
        tfe.MATModel().mats_for(algo, topo)


@pytest.mark.parametrize("k,used,inputs", [(1, 2, 7), (4, 3, 7), (3, 7, 7)])
def test_kmeans_mat_charges_what_the_lut_holds(k, used, inputs):
    topo = {"k": k, "n_features": used, "n_inputs": inputs}
    lut = next(s for s in tst.lower_topology("kmeans", topo, form="mat")
               if s.kind == "lut_gather")
    assert lut.params == inputs * tst.MAT_BINS * k
    assert (lut.n_in, lut.n_out) == (inputs, k)
    # without n_inputs (no feature subset) the charge is the JAX one
    plain = {"k": k, "n_features": inputs}
    assert _fields(tst.lower_topology("kmeans", plain, form="mat")) == \
        _fields(jst.lower_topology("kmeans", plain, form="mat"))


def _platforms(resources=None, performance=None):
    out = []
    for mod in (jal, tal):
        ps = [mod.Platforms.Taurus(), mod.Platforms.Tofino(),
              mod.Platforms.FPGA()]
        for p in ps:
            p.constrain(performance=performance or {}, resources=resources or {})
        out.append(ps)
    return out


def _report(r):
    return (r.feasible, r.reasons, r.resources, r.latency_ns, r.throughput_pps)


@pytest.mark.parametrize("constraints", [
    ({"rows": 16, "cols": 16}, {"throughput": 1, "latency": 500}),
    ({"rows": 4, "cols": 4, "tables": 3, "luts": 20000}, {"latency": 60}),
    ({}, {}),
])
def test_platform_verdicts_match(constraints):
    js, ts = _platforms(*constraints)
    for jp, tp in zip(js, ts):
        algos = jp.supported_algorithms()
        assert algos == tp.supported_algorithms()
        for algo, topo in TOPOLOGIES:
            if algo not in algos:
                continue
            assert _report(jp.check(algo, topo)) == \
                _report(tp.check(algo, topo)), (jp.kind, algo, topo)
        dnn = [t for a, t in TOPOLOGIES if a == "dnn"]
        if "dnn" in algos:
            assert [_report(r) for r in jp.check_batch("dnn", dnn)] == \
                [_report(r) for r in tp.check_batch("dnn", dnn)]


@pytest.mark.parametrize("kind", ["taurus", "tofino", "fpga"])
@pytest.mark.parametrize("n_slots,hists", [(1024, ()), (65536, (16, 8)),
                                           (1 << 22, (32,))])
def test_flowstate_and_mitigation_reports_match(kind, n_slots, hists):
    kw = dict(n_slots=n_slots, n_counters=2, n_ewma=1, hist_sizes=hists)
    a = jfe.flowstate_report(JSpec(**kw), kind)
    b = tfe.flowstate_report(TSpec(**kw), kind)
    assert _report(a) == _report(b)
    a = jfe.mitigation_report(JMitSpec(n_slots=n_slots), kind)
    b = tfe.mitigation_report(TMitSpec(n_slots=n_slots), kind)
    assert _report(a) == _report(b)


def test_gpu_model_reads_the_port_envelope():
    m = tfe.GPUModel()
    small = m.estimate("dnn", {"widths": [7, 16, 8, 2]})
    assert small["envelope"] is None and small["staged"]
    # weights + biases + the 8 warps' two activation rows of 256 floats
    assert small["smem_bytes"] == 4 * (7 * 16 + 16 + 16 * 8 + 8 + 8 * 2 + 2) \
        + 4 * 8 * 2 * 256
    assert small["macs_per_pkt"] == 7 * 16 + 16 * 8 + 8 * 2
    deep = m.estimate("dnn", {"widths": [30] + [128] * 10 + [2]})
    assert deep["envelope"] is None and not deep["staged"]
    assert deep["smem_bytes"] == 4 * 8 * 2 * 256
    wide = m.estimate("dnn", {"widths": [7, 300, 2]})
    assert "300" in wide["envelope"]
    p = tal.Platforms.GPU()
    p.constrain(performance={"latency": 1e9})
    assert p.check("dnn", {"widths": [7, 16, 8, 2]}).feasible
    bad = p.check("dnn", {"widths": [7, 300, 2]})
    assert not bad.feasible and "MLP kernels" in bad.reasons[0]
    assert not p.check("dnn", {"widths": [7] + [8] * 17 + [2]}).feasible
    assert small["latency_ns"] > m.launch_us * 1e3
    ok = tfe.flowstate_report(TSpec(n_slots=65536, n_counters=2), "gpu")
    assert ok.feasible and ok.resources["register_words"] == 65536 * 3
    big = tfe.flowstate_report(TSpec(n_slots=1 << 17, n_counters=2), "gpu")
    assert not big.feasible and "MAX_SLOTS" in big.reasons[0]


# ------------------------------------------------------------------ codegen


@pytest.fixture(scope="module")
def jax_models():
    d = jnd.make_ad_dataset(features=7, n_train=1024, n_test=512)
    models = {
        "dnn": jm.train_dnn(d, hidden=[16, 8], epochs=3, seed=0),
        "logreg": jm.train("logreg", d, {"lr": 0.1}, seed=0),
        "svm": jm.train_svm(d, c_reg=1.0, epochs=6, seed=0),
        "kmeans": jm.train_kmeans(d, k=4, seed=0),
        "kmeans_sub": jm.train("kmeans", d, {"k": 3, "n_features": 3}),
        "tree": jm.train_tree(d, max_depth=4, seed=0),
    }
    return d, models


def _same_stages(jax_stages, port_stages):
    want = convert.stages_from_reference(jax_stages)
    assert [s.kind for s in want] == [s.kind for s in port_stages]
    for a, b in zip(want, port_stages):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, list):
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
            elif isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


def _rep(mod, resources):
    return mod.FeasibilityReport(True, [], dict(resources), 1.0, 1e9)


TAURUS = ["dnn", "logreg", "svm", "kmeans", "kmeans_sub"]
MAT = ["svm", "logreg", "kmeans", "kmeans_sub", "tree"]


@pytest.mark.parametrize("algo", TAURUS)
def test_taurus_codegen_matches(jax_models, algo):
    d, models = jax_models
    res = {"cu": 24, "mu": 48, "ii": 1}
    jp = jcg.taurus_codegen(f"t_{algo}", models[algo], _rep(jfe, res))
    tm = convert.trained_from_reference(models[algo], n_inputs=7,
                                        device="cpu")
    tp = tcg.taurus_codegen(f"t_{algo}", tm, _rep(tfe, res), device="cpu")
    assert tp.source == jp.source
    _same_stages(jp.stages, tp.stages)
    assert tp.stage_summary() == jp.stage_summary()
    assert tp.verify(d.test_x) == 0.0
    outside, _ = tp.mismatches(d.test_x)
    assert outside == 0
    # the trained model carried across predicts as the JAX one, up to the
    # margin rule for the float forwards
    diff = tm.predict(d.test_x) != models[algo].predict(d.test_x)
    if tm.scores is None or not diff.any():
        assert not diff.any()
    else:
        top = np.sort(tm.scores(d.test_x), 1)
        gap = top[:, -1] - top[:, -2] if algo in ("dnn", "logreg", "svm") \
            else top[:, 1] - top[:, 0]
        assert np.all(gap[diff] <= tcg.MARGIN)


@pytest.mark.parametrize("algo", MAT)
def test_mat_codegen_matches(jax_models, algo):
    d, models = jax_models
    res = {"mats": 7}
    jp = jcg.mat_codegen(f"m_{algo}", models[algo], _rep(jfe, res),
                         d.train_x)
    tm = convert.trained_from_reference(models[algo], n_inputs=7,
                                        device="cpu")
    tp = tcg.mat_codegen(f"m_{algo}", tm, _rep(tfe, res), d.train_x,
                         device="cpu")
    assert tp.source == jp.source
    _same_stages(jp.stages, tp.stages)
    np.testing.assert_array_equal(tp(d.test_x), jp(d.test_x))
    assert tp.verify(d.test_x, max_mismatch_frac=0.03) <= 0.03


@pytest.mark.parametrize("algo,want", [
    ("dnn", ("pallas", "cpu-ref")), ("svm", ("pallas", "cpu-ref")),
    ("kmeans", ("interpret", "interpret")),
])
def test_compiled_backend_reported_as_the_reference(jax_models, algo, want):
    """What serves: the kernel lowering (``pallas`` in the JAX package,
    ``cuda`` on the card, its plain versions ``cpu-ref`` on the CPU) or
    the plain walk (``interpret`` in both)."""
    d, models = jax_models
    res = {"cu": 1}
    jp = jcg.taurus_codegen("x", models[algo], _rep(jfe, res),
                            exec_backend="pallas")
    tp = tcg.taurus_codegen(
        "x", convert.trained_from_reference(models[algo], device="cpu"),
        _rep(tfe, res), device="cpu")
    assert (jp.compiled_backend, tp.compiled_backend) == want
    walked = tcg.taurus_codegen(
        "x", convert.trained_from_reference(models[algo], device="cpu"),
        _rep(tfe, res), exec_backend="interpret", device="cpu")
    assert walked.compiled_backend == "interpret"
    np.testing.assert_array_equal(walked(d.test_x[:64]),
                                  tp(d.test_x[:64]))


def test_tree_mat_walks_and_is_exact(jax_models):
    d, models = jax_models
    tm = convert.trained_from_reference(models["tree"], device="cpu")
    tp = tcg.generate_pipeline("tofino", "t", tm, _rep(tfe, {"mats": 4}),
                               d.train_x, device="cpu")
    assert tp.compiled_backend == "interpret"
    assert tp.verify(d.test_x) == 0.0
    assert tp.mismatches(d.test_x) == (0, 0)


def test_generate_pipeline_targets(jax_models):
    d, models = jax_models
    tm = convert.trained_from_reference(models["dnn"], device="cpu")
    for kind in ("taurus", "gpu", "fpga"):
        p = tcg.generate_pipeline(kind, "g", tm, _rep(tfe, {}), d.train_x,
                                  device="cpu")
        assert p.backend == kind and p.stages[0].kind == "fused_mlp"
    with pytest.raises(KeyError):
        tcg.generate_pipeline("tpu", "g", tm, _rep(tfe, {}), d.train_x,
                              device="cpu")
