"""Port parity: the fused stateful launch (K1's function) and the CUDA
lowering's pattern matching.

The JAX ``fused_flow_serve`` with a single-table ``"mlp"`` plan (Pallas
``_serve_kernel``, interpret mode on the CPU) against the port's
``fused_flow_serve`` on CPU tensors (its plain version), over the
collision patterns of ``repro_torch.testing``.  Keys and register rows
match bit for bit, readout rows too; verdicts under the margin rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.core import pallas_backend as jpb  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.flowstate import MitigationSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.kernels import fused_flow as jff  # noqa: E402
from repro.kernels import fused_mlp as jfm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import cuda_backend, stageir  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.flowstate.registers import FlowStateSpec  # noqa: E402
from repro_torch.kernels import flow_update as tfu  # noqa: E402
from repro_torch.kernels import fused_flow as tff  # noqa: E402
from repro_torch.kernels import fused_mlp as tfm  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    PATTERNS,
    flow_batch,
    random_mlp,
    verdict_mismatches,
)

N_SLOTS, B = 64, 256
SPEC = FlowStateSpec(n_slots=N_SLOTS, n_counters=2, n_ewma=2,
                     hist_sizes=(16, 8), ewma_alpha=0.125)
W = SPEC.width


def _t(a):
    return torch.as_tensor(np.array(a))


def _plans(mode):
    n_in = W - 4 if mode == "hist" else W
    widths = (n_in, 16, 8, 2)
    ws, bs = random_mlp(widths, seed=5)
    lane = jfm.snap_lane(list(widths), interpret=True)
    jarr = jfm.pack_params([jnp.asarray(w) for w in ws],
                           [jnp.asarray(b) for b in bs], lane)
    jtp = jff.TablePlan(2, 2, 2, 0.125, W, mode)
    jsp = jff.SuffixPlan("mlp", 2, n_layers=3, lane=lane)
    ttp = tff.TablePlan(2, 2, 2, 0.125, W, mode)
    return (jtp, jsp, jarr), (ttp, tff.SuffixPlan("mlp", 2),
                              tfm.pack_params(ws, bs))


def _serve_both(pattern, ragged, mode, steps=2):
    (jtp, jsp, jarr), (ttp, tsp, tmlp) = _plans(mode)
    jk = jnp.full((N_SLOTS,), -1, jnp.int32)
    jr = jnp.zeros((N_SLOTS, W), jnp.float32)
    tk, tr = _t(np.asarray(jk)), _t(np.asarray(jr))
    for step in range(steps):
        b = flow_batch(SPEC, pattern, B, seed=7 * step + 2, ragged=ragged)
        # the plain walk gives the logits the margin rule reads
        _, _, feats = tfu.flow_update_ref(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), n_counters=2, n_ewma=2, alpha=0.125)
        logits = tff.ref.suffix_logits(tff.suffix_readout(feats, ttp),
                                       tmlp).numpy()
        jk, jr, jv = jff.fused_flow_serve(
            [(jk, jr, b["pkt_keys"], b["upd"], b["bins"])], b["valid"],
            (jtp,), jsp, jarr)
        tk, tr, tv = tff.fused_flow_serve(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), ttp, tsp, tmlp)
        yield b, (np.asarray(jk), np.asarray(jr), np.asarray(jv)), \
            (tk.numpy(), tr.numpy(), tv.numpy()), logits


@pytest.mark.parametrize("pattern,ragged",
                         [(p, r) for p in PATTERNS for r in (False, True)])
def test_fused_serve_matches_reference(pattern, ragged):
    for b, (jk, jr, jv), (tk, tr, tv), logits in _serve_both(
            pattern, ragged, "all"):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tr.view(np.int32), jr.view(np.int32))
        bad, close = verdict_mismatches(tv, logits)
        assert bad == 0 and close <= B // 100
        # padding rows classify the all-zero readout in both packages
        assert verdict_mismatches(jv, logits)[0] == 0
        assert tv.dtype == np.int32 and tv.shape == (B,)


@pytest.mark.parametrize("mode", ["hist", "raw"])
def test_fused_serve_readout_modes(mode):
    for b, (jk, jr, jv), (tk, tr, tv), logits in _serve_both(
            "mixed", True, mode, steps=1):
        np.testing.assert_array_equal(tr, jr)
        assert verdict_mismatches(tv, logits)[0] == 0
        assert verdict_mismatches(jv, logits)[0] == 0


@pytest.mark.parametrize("mode", ["all", "hist", "raw"])
def test_readout_matches_reference_bitwise(mode):
    rng = np.random.default_rng(4)
    feats = rng.integers(0, 50, (B, W)).astype(np.float32)
    feats[:, 2:4] = rng.random((B, 2)).astype(np.float32) * 1500
    feats[:8, 0] = 0.0                        # count 0 divides by 1
    jz = np.asarray(jff.suffix_readout(
        jnp.asarray(feats), jff.TablePlan(2, 2, 2, 0.125, W, mode)))
    tz = tff.suffix_readout(_t(feats),
                            tff.TablePlan(2, 2, 2, 0.125, W, mode)).numpy()
    np.testing.assert_array_equal(tz.view(np.int32), jz.view(np.int32))


def test_launch_wrapper_refuses_cpu_tensors():
    (_, _, _), (ttp, tsp, tmlp) = _plans("all")
    b = flow_batch(SPEC, "mixed", 8, seed=0)
    *ops, seg = tfu.ops.prepare_operands(
        torch.full((N_SLOTS,), -1, dtype=torch.int32), torch.zeros((N_SLOTS, W)),
        _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]), _t(b["valid"]))
    with pytest.raises(ValueError, match="CUDA"):
        tff.fused_flow_serve_launch(*ops, seg, ttp, tsp, tmlp)


# ------------------------------------------------ lowering / decline


def _reference_stages(suffix_kind):
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    rng = np.random.default_rng(0)
    n_in = ws.n_out
    if suffix_kind == "mlp":
        w, b = random_mlp((n_in, 16, 8, 2), seed=1)
        return [fk, ru, ws, jstageir.FusedMLP(w, b), jstageir.Reduce("argmax")]
    if suffix_kind == "logits":
        w, b = random_mlp((n_in, 16, 2), seed=1)
        return [fk, ru, ws, jstageir.FusedMLP(w, b)]
    if suffix_kind in ("mat", "mat_wide"):
        bins = 8 if suffix_kind == "mat" else 1100
        edges = np.sort(rng.random((n_in, bins - 1)).astype(np.float32),
                        axis=1)
        return [fk, ru, ws, jstageir.Quantize(edges),
                jstageir.LUTGather(rng.random((n_in, bins, 4))
                                   .astype(np.float32)),
                jstageir.Reduce("argmax"),
                jstageir.LabelMap(np.asarray([0, 1, 1, 0], np.int32))]
    if suffix_kind in ("centroid", "centroid_wide"):
        k = 3 if suffix_kind == "centroid" else 200
        return [fk, ru, ws,
                jstageir.CentroidDistance(rng.random((k, n_in)).astype(np.float32)),
                jstageir.Reduce("argmin")]
    if suffix_kind == "mitigate":
        return _reference_stages("mlp") + [
            jstageir.Mitigate(MitigationSpec(n_slots=N_SLOTS, threshold=3))]
    raise KeyError(suffix_kind)


@pytest.mark.parametrize("kind,reason", [
    ("mat_wide", "bins > 1024"),
    ("logits", "argmax"),
])
def test_cuda_backend_declines_by_name(kind, reason):
    """What the port cannot lower declines with its reason on both paths
    (a MAT beyond the kernels' bins, a logits-only MLP); the plain walk
    still serves what it can apply."""
    stages = convert.stages_from_reference(_reference_stages(kind))
    prefix, suffix = stages[:2], stages[2:]
    assert reason in cuda_backend.fused_flow_decline_reason(prefix, suffix)
    assert cuda_backend.lower_stateful_fused(prefix, suffix, "cpu") is None
    for fuse in (True, False):
        with pytest.raises(ValueError, match=reason):
            StatefulPipeline(stages, backend="cuda", fuse=fuse, device="cpu")
    if kind != "logits":
        pipe = StatefulPipeline(stages, backend="interpret", device="cpu")
        assert pipe.backend == "interpret"


@pytest.mark.parametrize("kind", ["mat", "centroid", "mitigate"])
def test_cuda_backend_serves_mat_centroid_and_mitigation(kind):
    """No decline for a MAT suffix, a centroid suffix or a single-table
    Mitigate: one K1 launch fused; split as the JAX package splits it
    (K2 + K4 "cpu-ref"; the centroid suffix and the action table in
    their plain walks, "mixed")."""
    stages = convert.stages_from_reference(_reference_stages(kind))
    rest, mit = stageir.split_mitigation(stages)
    assert cuda_backend.fused_flow_decline_reason(rest[:2], rest[2:],
                                                  mit) is None
    fused = StatefulPipeline(stages, backend="cuda", device="cpu")
    split = StatefulPipeline(stages, backend="cuda", fuse=False,
                             device="cpu")
    jsplit = JPipeline(_reference_stages(kind), backend="pallas", fuse=False)
    assert fused.backend == "cpu-ref-fused-flow"
    assert split.backend == {"mat": "cpu-ref"}.get(kind, "mixed")
    assert jsplit.backend == {"mat": "pallas"}.get(kind, "mixed")
    x = jtraffic.make_stream("ddos_burst", n_packets=300, seed=2).packets
    _, vf = fused(fused.init_state(), x)
    _, vs = split(split.init_state(), x)
    np.testing.assert_array_equal(vf, vs)


def test_centroid_outside_the_envelope():
    """Past 128 centroids K1 declines by name; the split path walks the
    centroid suffix in plain PyTorch, as the JAX package walks it in jnp
    (there is no stateless centroid kernel in either package)."""
    stages = convert.stages_from_reference(_reference_stages("centroid_wide"))
    reason = cuda_backend.fused_flow_decline_reason(stages[:2], stages[2:])
    assert "200 centroids" in reason and "not yet ported" not in reason
    with pytest.raises(ValueError, match="200 centroids"):
        StatefulPipeline(stages, backend="cuda", device="cpu")
    split = StatefulPipeline(stages, backend="cuda", fuse=False, device="cpu")
    assert split.backend == "mixed" and split.classifier_backend == "interpret"


def test_mitigation_and_multi_table_raise_not_implemented():
    """A single-table ``Mitigate`` lowers (4 state arrays), and so do
    multi-table pipelines now: the second table no longer raises
    ``NotImplementedError`` or declines; they serve fused
    (``cpu-ref-fused-flow`` here, ``cuda-fused-flow`` on the card) and
    split (``cpu-ref``, ``cuda`` on the card), with 2 state arrays per
    table."""
    stages = convert.stages_from_reference(_reference_stages("mitigate"))
    for backend in ("cuda", "interpret"):
        pipe = StatefulPipeline(stages, backend=backend, device="cpu")
        assert pipe.n_state_arrays == 4
    rest, mit = stageir.split_mitigation(stages)
    prefix, suffix = rest[:2], rest[2:]
    assert cuda_backend.fused_flow_decline_reason(
        prefix, suffix, mitigation=mit) is None
    groups = [tuple(prefix) + (suffix[0],)] * 2
    fk, ru, ws = groups[0]
    w, b = random_mlp((2 * ws.n_out, 8, 2), seed=3)
    two = [fk, ru, ws, fk, ru, ws, stageir.FusedMLP(w, b),
           stageir.Reduce("argmax")]
    assert cuda_backend.fused_flow_decline_reason(groups, two[6:]) is None
    for fuse, name in ((True, "cpu-ref-fused-flow"), (False, "cpu-ref")):
        pipe = StatefulPipeline(two, backend="cuda", fuse=fuse,
                                device="cpu")
        assert pipe.backend == name and pipe.n_tables == 2
        assert pipe.n_state_arrays == 4
    assert stageir.kernel_backend(torch.device("cuda")) == "cuda"


@pytest.mark.parametrize("pattern", PATTERNS)
def test_fused_centroid_suffix_matches_pallas(pattern):
    """K1's "centroid" plain version against the Pallas kernel in
    interpret mode (a folded FeatureSelect, argmin, a LabelMap): state
    bit for bit, distances within rtol=atol=1e-5 of the JAX stage walk,
    verdicts under the margin rule (margin rows counted)."""
    rng = np.random.default_rng(9)
    cent = rng.random((5, 6)).astype(np.float32) * 3
    fidx = (0, 2, 4, 5, 9, 12)
    sfx = ("centroid", fidx, cent, np.asarray([1, 0, 1, 2, 0], np.int32),
           True)
    jsp, jarr = jpb._pack_suffix(sfx, 8, True)
    tc = tff.pack_centroids(cent, sfx[3], fidx, use_min=True)
    jk, jr = jnp.full((N_SLOTS,), -1, jnp.int32), jnp.zeros((N_SLOTS, W))
    tk, tr = _t(np.asarray(jk)), _t(np.asarray(jr))
    jtp = jff.TablePlan(2, 2, 2, 0.125, W, "all")
    ttp = tff.TablePlan(2, 2, 2, 0.125, W, "all")
    for step in range(2):
        b = flow_batch(SPEC, pattern, B, seed=step + 21, ragged=step == 1)
        _, _, feats = tfu.flow_update_ref(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), n_counters=2, n_ewma=2, alpha=0.125)
        z = tff.suffix_readout(feats, ttp)
        dist = tff.centroid_scores_ref(z, tc).numpy()
        jdist = np.asarray(jstageir.CentroidDistance(cent).apply(
            jnp.asarray(z.numpy()[:, list(fidx)])))
        np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=1e-5)
        jk, jr, jv = jff.fused_flow_serve(
            [(jk, jr, b["pkt_keys"], b["upd"], b["bins"])], b["valid"],
            (jtp,), jsp, jarr)
        tk, tr, tv = tff.fused_flow_serve(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), ttp, tff.SuffixPlan("centroid", 5), tc)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                      np.asarray(jr).view(np.int32))
        lm = np.asarray(sfx[3])
        for v in (tv.numpy(), np.asarray(jv)):
            bad, close = verdict_mismatches(v, jdist, use_min=True,
                                            label_map=lm)
            assert bad == 0 and close <= B // 100


def test_fused_centroid_ties_break_to_lowest_index():
    """Duplicated centroids: every packet nearest the pair is an exact
    distance tie; the masked argmin picks the lowest index in both
    packages (label 9 never wins).  Port of
    tests/test_fused_flow.py::test_fused_centroid_ties_break_to_lowest_index."""
    spec = JSpec(n_slots=64, n_counters=1, n_ewma=1, hist_sizes=(4,),
                 ewma_alpha=0.25)
    fk = jstageir.FlowKey((0,), 64)
    ru = jstageir.RegisterUpdate(spec, ewma_cols=(1,), hist_cols=(1,),
                                 hist_edges=(np.asarray([0.25, 0.5, 0.75]),))
    cent = np.asarray([[0.5, 0.25], [4.0, 4.0], [0.5, 0.25]], np.float32)
    jstages = [fk, ru, jstageir.WindowStats(spec, mode="all"),
               jstageir.FeatureSelect((0, 2)),
               jstageir.CentroidDistance(cent), jstageir.Reduce("argmin"),
               jstageir.LabelMap(np.asarray([5, 7, 9], np.int32))]
    jp = JPipeline(jstages, backend="pallas")
    assert jp.backend == "pallas-fused-flow"
    tp = StatefulPipeline(convert.stages_from_reference(jstages),
                          backend="cuda", device="cpu")
    assert tp.backend == "cpu-ref-fused-flow"
    rng = np.random.default_rng(0)
    js_, ts_ = jp.init_state(), tp.init_state()
    for chunk in range(3):
        X = np.zeros((96, 2), np.float32)
        X[:, 0] = rng.integers(0, 9, 96)
        X[:, 1] = (rng.integers(0, 5, 96) * 0.25).astype(np.float32)
        js_, jv = jp(js_, X)
        ts_, tv = tp(ts_, X)
        np.testing.assert_array_equal(tv, jv, err_msg=f"chunk {chunk}")
        assert set(np.unique(tv)) <= {5, 7}
    np.testing.assert_array_equal(ts_.regs.numpy(), np.asarray(js_.regs))


def test_backend_names_are_honest():
    stages = convert.stages_from_reference(_reference_stages("mlp"))
    names = {
        (b, f): StatefulPipeline(stages, backend=b, fuse=f,
                                 device="cpu").backend
        for b in ("cuda", "interpret") for f in (True, False)
    }
    assert names == {("cuda", True): "cpu-ref-fused-flow",
                     ("cuda", False): "cpu-ref",
                     ("interpret", True): "interpret",
                     ("interpret", False): "interpret"}
    pipe = StatefulPipeline(stages, backend="cuda", fuse=False, device="cpu")
    assert pipe.with_backend("cuda").fuse is False
    assert pipe.fallback_reason is None
    with pytest.raises(KeyError):
        StatefulPipeline(stages, backend="pallas", device="cpu")


def test_interpret_walk_runs_no_kernel_op(monkeypatch):
    """The interpret backend unfuses FusedClassify and never reaches the
    kernel op, whatever the device."""
    stages = convert.stages_from_reference(_reference_stages("mlp"))
    stages = stages[:3] + stageir.fuse_pipeline_stages(stages[3:])
    assert isinstance(stages[3], stageir.FusedClassify)

    def boom(*a, **k):
        raise AssertionError("kernel op reached from the interpret walk")

    monkeypatch.setattr(tfm, "fused_mlp_classify_packed", boom)
    pipe = StatefulPipeline(stages, backend="interpret", device="cpu")
    x = jtraffic.make_stream("ddos_burst", n_packets=64, seed=1).packets
    _, v = pipe(pipe.init_state(), x)
    assert v.shape == (64,)
