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
from repro.flowstate import MitigationSpec  # noqa: E402
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
    if suffix_kind == "mat":
        edges = np.sort(rng.random((n_in, 7)).astype(np.float32), axis=1)
        return [fk, ru, ws, jstageir.Quantize(edges),
                jstageir.LUTGather(rng.random((n_in, 8, 4)).astype(np.float32)),
                jstageir.Reduce("argmax"),
                jstageir.LabelMap(np.asarray([0, 1, 1, 0], np.int32))]
    if suffix_kind == "centroid":
        return [fk, ru, ws,
                jstageir.CentroidDistance(rng.random((3, n_in)).astype(np.float32)),
                jstageir.Reduce("argmin")]
    if suffix_kind == "mitigate":
        return _reference_stages("mlp") + [
            jstageir.Mitigate(MitigationSpec(n_slots=N_SLOTS, threshold=3))]
    raise KeyError(suffix_kind)


@pytest.mark.parametrize("kind,reason", [
    ("mat", "mat suffix not yet ported"),
    ("centroid", "centroid suffix not yet ported"),
    ("logits", "argmax"),
])
def test_cuda_backend_declines_by_name(kind, reason):
    stages = convert.stages_from_reference(_reference_stages(kind))
    prefix, suffix = stages[:2], stages[2:]
    assert reason in cuda_backend.fused_flow_decline_reason(prefix, suffix)
    assert cuda_backend.lower_stateful_fused(prefix, suffix, "cpu") is None
    for fuse in (True, False):
        with pytest.raises(ValueError, match=reason):
            StatefulPipeline(stages, backend="cuda", fuse=fuse, device="cpu")
    # the plain stage walk serves what it can apply
    if kind != "logits":
        pipe = StatefulPipeline(stages, backend="interpret", device="cpu")
        assert pipe.backend == "interpret"


def test_mitigation_and_multi_table_raise_not_implemented():
    stages = convert.stages_from_reference(_reference_stages("mitigate"))
    for backend in ("cuda", "interpret"):
        with pytest.raises(NotImplementedError, match="Mitigate"):
            StatefulPipeline(stages, backend=backend, device="cpu")
    two = stages[:2] + stages[:-1]
    with pytest.raises(NotImplementedError, match="multi-table"):
        StatefulPipeline(two, backend="cuda", device="cpu")
    prefix, suffix = stages[:2], stages[2:-1]
    assert cuda_backend.fused_flow_decline_reason(
        prefix, suffix, mitigation=stages[-1]) == "mitigation not yet ported"
    assert cuda_backend.fused_flow_decline_reason(
        [tuple(prefix), tuple(prefix)], suffix) \
        == "multi-table plans not yet ported"


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
