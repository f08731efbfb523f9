"""Port parity: every ported stateless stage ``apply`` against the JAX
stage it was converted from (``convert.stages_from_reference``).

Integer outputs (Quantize buckets, Reduce, LabelMap, FeatureSelect) and
the elementwise WindowStats readout match exactly; sums over features or
layers (Dense, FusedMLP, CentroidDistance, LUTGather) within
rtol=atol=1e-5, because the two frameworks sum in different orders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stageir as js  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import stageir as ts  # noqa: E402
from repro_torch.flowstate.pipeline import REPORT_BACKENDS  # noqa: E402

RNG = np.random.default_rng(0)
B, F = 96, 6


def _stage(kind):
    if kind == "feature_select":
        return js.FeatureSelect(np.array([4, 0, 2])), "x", True
    if kind == "dense":
        return js.Dense(RNG.normal(size=(F, 5)).astype(np.float32),
                        RNG.normal(size=5).astype(np.float32), "relu"), \
            "x", False
    if kind == "dense_linear":
        return js.Dense(RNG.normal(size=(F, 3)).astype(np.float32),
                        RNG.normal(size=3).astype(np.float32)), "x", False
    if kind == "fused_mlp":
        return js.FusedMLP(
            [RNG.normal(size=(F, 8)).astype(np.float32),
             RNG.normal(size=(8, 3)).astype(np.float32)],
            [RNG.normal(size=8).astype(np.float32),
             RNG.normal(size=3).astype(np.float32)]), "x", False
    if kind == "centroid_distance":
        return js.CentroidDistance(RNG.normal(size=(4, F)).astype(
            np.float32)), "x", False
    if kind == "quantize":
        return js.Quantize(np.sort(RNG.normal(size=(F, 9)), 1).astype(
            np.float32)), "x", True
    if kind == "lut_gather":
        return js.LUTGather(RNG.normal(size=(F, 10, 3)).astype(
            np.float32)), "bins", False
    if kind in ("argmax", "argmin"):
        return js.Reduce(kind), "x", True
    if kind == "label_map":
        return js.LabelMap(np.array([2, 0, 1, 1, 0, 2], np.int32)), \
            "ids", True
    if kind == "tree_traverse":
        nodes = [{"feat": 2, "thr": 0.0, "left": 1, "right": 2},
                 {"feat": 0, "thr": -0.5, "left": 3, "right": 4},
                 {"leaf": 2},
                 {"leaf": 1},
                 {"feat": 5, "thr": 0.25, "left": 5, "right": 6},
                 {"leaf": 0},
                 {"leaf": 3}]
        return js.TreeTraverse.from_nodes(nodes, depth=3), "x", True
    if kind in ("window_all", "window_hist"):
        spec = JSpec(n_slots=8, n_counters=2, n_ewma=1, hist_sizes=(2, 1))
        return js.WindowStats(spec, mode=kind.split("_")[1]), "feats", True
    raise KeyError(kind)


def _input(which):
    if which == "x":
        x = RNG.normal(size=(B, F)).astype(np.float32)
        x[:4] = x[4:8]                           # repeated rows: ties
        x[8:12, 2] = 0.0                         # on a tree threshold
        x[12:16, 0] = -0.5
        return x
    if which == "bins":
        return RNG.integers(0, 10, (B, F)).astype(np.int32)
    if which == "ids":
        return RNG.integers(0, 6, B).astype(np.int32)
    feats = RNG.integers(0, 9, (B, F)).astype(np.float32)
    feats[:5, 0] = 0.0                           # count 0 divides by 1
    return feats


KINDS = ["feature_select", "dense", "dense_linear", "fused_mlp",
         "centroid_distance", "quantize", "lut_gather", "argmax", "argmin",
         "label_map", "window_all", "window_hist", "tree_traverse"]


@pytest.mark.parametrize("kind", KINDS)
def test_stage_apply_matches_reference(kind):
    jstage, which, exact = _stage(kind)
    (tstage,) = convert.stages_from_reference([jstage])
    assert tstage.kind == jstage.kind
    x = _input(which)
    want = np.asarray(jstage.apply(jnp.asarray(x)))
    got = tstage.apply(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_peephole_round_trip():
    w = [RNG.normal(size=(F, 3)).astype(np.float32)]
    b = [np.zeros(3, np.float32)]
    stages = [ts.FusedMLP(w, b), ts.Reduce("argmax"), ts.Reduce("argmin")]
    fused = ts.fuse_pipeline_stages(stages)
    assert [s.kind for s in fused] == ["fused_classify", "reduce"]
    plain = ts.unfuse_pipeline_stages(fused)
    assert [s.kind for s in plain] == ["fused_mlp", "reduce", "reduce"]
    x = torch.as_tensor(_input("x"))
    np.testing.assert_array_equal(fused[0].apply(x).numpy(),
                                  ts.apply_stages(plain[:2], x).numpy())
    assert set(REPORT_BACKENDS) >= {"cuda-fused-flow", "cuda", "interpret"}


def test_split_grammar_matches_reference():
    spec = JSpec(n_slots=8, n_counters=1)
    fk, ru = js.FlowKey((0,), 8), js.RegisterUpdate(spec)
    red = js.Reduce("argmax")
    tfk, tru, tred = convert.stages_from_reference([fk, ru, red])
    assert ts.split_stateful([tfk, tru, tred])[1] == [tred]
    for bad in ([tru, tfk], [tfk], [tfk, tru, tfk]):
        with pytest.raises(ValueError):
            ts.split_stateful(bad)
    mit = ts.Mitigate({"n_slots": 8})
    assert ts.split_mitigation([tfk, tru, tred, mit])[1] is mit
    with pytest.raises(ValueError, match="LAST"):
        ts.split_mitigation([tfk, mit, tru])
    for stage in (tfk, tru, mit):
        with pytest.raises(TypeError):
            stage.apply(torch.zeros(2, 1))


def test_compile_stages_reports_and_rejects_stateful():
    """``compile_stages``: the stage list it compiled, the backend that
    serves (the JAX package's rule: a kernel for an MLP or MAT, the walk
    for a centroid or tree classifier), and a stateful stage refused as
    the JAX package refuses it."""
    jw = [RNG.normal(size=(F, 4)).astype(np.float32),
          RNG.normal(size=(4, 3)).astype(np.float32)]
    jb = [np.zeros(4, np.float32), np.zeros(3, np.float32)]
    jstages = [js.FusedMLP(jw, jb), js.Reduce("argmax")]
    tstages = convert.stages_from_reference(jstages)
    x = _input("x")
    for backend, jbackend in (("interpret", "interpret"), ("cuda", "pallas")):
        comp = ts.compile_stages(tstages, backend=backend, device="cpu")
        jcomp = js.compile_stages(jstages, backend=jbackend)
        assert comp.backend == jcomp.backend.replace("pallas", "cpu-ref")
        assert comp.requested_backend == backend
        assert [s.kind for s in comp.stages] == ["fused_mlp", "reduce"]
        np.testing.assert_array_equal(comp(x).numpy(),
                                      np.asarray(jcomp(jnp.asarray(x))))
    cen = convert.stages_from_reference([_stage("centroid_distance")[0],
                                         js.Reduce("argmin")])
    assert ts.compile_stages(cen, backend="cuda",
                             device="cpu").backend == "interpret"
    tree = convert.stages_from_reference([_stage("tree_traverse")[0]])
    assert ts.compile_stages(tree, backend="cuda",
                             device="cpu").backend == "interpret"
    spec = JSpec(n_slots=8, n_counters=1)
    stateful = convert.stages_from_reference(
        [js.FlowKey((0,), 8), js.RegisterUpdate(spec), js.Reduce("argmax")])
    with pytest.raises(ValueError, match="stateful"):
        ts.compile_stages(stateful, device="cpu")
    with pytest.raises(ValueError, match="stateful"):
        js.compile_stages([js.FlowKey((0,), 8), js.RegisterUpdate(spec)])
    with pytest.raises(KeyError):
        ts.compile_stages(tstages, backend="pallas", device="cpu")
    assert set(REPORT_BACKENDS) >= {"cuda-fused-dag", "cpu-ref-fused-dag"}
