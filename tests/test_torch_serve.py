"""Port parity for the slice as a whole: the flow-ddos stateful serving
path through ``PacketServeEngine``.

The reference builds ``traffic.flow_feature_stages(n_slots=64)`` plus a
seeded ``FusedMLP([28, 16, 8, 2]) + Reduce("argmax")``; the port serves
the same stages through ``convert.stages_from_reference``.  A 2,000-packet
``ddos_burst`` stream (a ragged tail at ``max_batch=256``) goes through
the JAX engine on ``backend="pallas"`` and the port's engine on
``backend="cuda", device="cpu"`` for ``fuse=True/False`` and
``depth=1/2``: the final register state must match bit for bit and the
verdict stream under the margin rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import MitigationSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.serve.packet_engine import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.data import traffic  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.serve.packet_engine import PacketServeEngine  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    plain_stream,
    readout_moments,
    random_mlp,
    verdict_mismatches,
)

N_SLOTS, MAX_BATCH, N_PACKETS, CHUNK = 64, 256, 2000, 300


@pytest.fixture(scope="module")
def case():
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    w, b = random_mlp((ws.n_out, 16, 8, 2), seed=0)
    jstages = [fk, ru, ws, jstageir.FusedMLP(w, b), jstageir.Reduce("argmax")]
    tstages = convert.stages_from_reference(jstages)
    stream = jtraffic.make_stream("ddos_burst", n_packets=N_PACKETS, seed=1)
    keys, regs, logits = plain_stream(tstages, stream.packets, MAX_BATCH,
                                      "cpu")
    return {"jstages": jstages, "tstages": tstages, "stream": stream,
            "keys": keys, "regs": regs, "logits": logits, "jpipes": {}}


def test_port_stream_equals_reference_stream():
    for scenario in ("ddos_burst", "benign"):
        a = jtraffic.make_stream(scenario, n_packets=N_PACKETS, seed=1)
        b = traffic.make_stream(scenario, n_packets=N_PACKETS, seed=1)
        np.testing.assert_array_equal(a.packets, b.packets)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert N_PACKETS % MAX_BATCH, "the stream must leave a ragged tail"


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_matches_reference(case, fuse, depth):
    jp = case["jpipes"].setdefault(
        fuse, JPipeline(case["jstages"], backend="pallas", fuse=fuse))
    jeng = JEngine(jp, feature_dim=4, max_batch=MAX_BATCH, depth=depth,
                   telemetry=False)
    jv = np.concatenate(list(jeng.serve_stream(case["stream"].chunks(CHUNK))))

    tp = StatefulPipeline(case["tstages"], backend="cuda", fuse=fuse,
                          device="cpu")
    teng = PacketServeEngine(tp, feature_dim=4, max_batch=MAX_BATCH,
                             depth=depth, device="cpu")
    tv = np.concatenate(list(teng.serve_stream(case["stream"].chunks(CHUNK))))

    keys, regs = convert.state_to_numpy(teng.state)
    np.testing.assert_array_equal(keys, np.asarray(jeng.state.keys))
    np.testing.assert_array_equal(regs.view(np.int32),
                                  np.asarray(jeng.state.regs).view(np.int32))
    np.testing.assert_array_equal(keys, case["keys"])
    np.testing.assert_array_equal(regs, case["regs"])
    assert tv.shape == jv.shape == (N_PACKETS,)
    bad, close = verdict_mismatches(tv, case["logits"])
    print(f"fuse={fuse} depth={depth}: {close} rows within the margin")
    assert bad == 0 and close <= N_PACKETS // 100
    assert verdict_mismatches(jv, case["logits"])[0] == 0

    st = teng.stats()
    want = "cpu-ref-fused-flow" if fuse else "cpu-ref"
    assert st["backend"] == want and tp.backend == want
    assert st["backend_batches"] == {want: -(-N_PACKETS // MAX_BATCH)}
    assert st["packets"] == N_PACKETS
    assert st["pad_packets"] == MAX_BATCH - N_PACKETS % MAX_BATCH
    assert st["depth"] == depth and st["pkt_per_s"] > 0
    assert 0 < st["lat_p50_ms"] <= st["lat_p99_ms"]
    assert st["dispatch_s"] > 0 and st["wall_s"] > 0


def test_submit_flush_equals_stream_and_resumes_state(case):
    """submit/flush in uneven pieces gives the stream's verdicts, and an
    engine resumed from a carried state continues the same chain."""
    pk = case["stream"].packets
    tp = StatefulPipeline(case["tstages"], backend="cuda", device="cpu")
    eng = PacketServeEngine(tp, feature_dim=4, max_batch=MAX_BATCH,
                            device="cpu")
    out = []
    for lo, hi in ((0, 7), (7, 900), (900, 1000)):
        eng.submit(pk[lo:hi])
        out.append(eng.flush())
    keys, regs = convert.state_to_numpy(eng.state)
    state = convert.state_from_numpy(keys, regs, tp.spec, device="cpu")
    eng2 = PacketServeEngine(tp, feature_dim=4, max_batch=MAX_BATCH,
                             device="cpu", state=state)
    eng2.submit(pk[1000:])
    out.append(eng2.flush())
    v = np.concatenate(out)
    assert verdict_mismatches(v, case["logits"])[0] == 0
    np.testing.assert_array_equal(eng2.state.regs.numpy(), case["regs"])
    assert eng.flush().shape == (0,)


def test_engine_backend_rebind_keeps_fuse_and_refuses(case):
    """``backend=`` recompiles keeping ``fuse``; a MAT suffix and a
    ``Mitigate`` stage now serve on ``backend="cuda"``, while a MAT past
    the kernels' envelope gets a clear error."""
    tp = StatefulPipeline(case["tstages"], backend="interpret", fuse=False,
                          device="cpu")
    eng = PacketServeEngine(tp, feature_dim=4, max_batch=64,
                            backend="cuda", device="cpu")
    assert eng.backend == "cpu-ref" and eng.pipeline.fuse is False
    with pytest.raises(ValueError, match="features"):
        eng.submit(np.zeros((3, 5), np.float32))
    jstages = case["jstages"]
    (fk, ru, ws) = jstages[:3]
    rng = np.random.default_rng(0)

    def mat(bins):
        return convert.stages_from_reference([
            fk, ru, ws,
            jstageir.Quantize(np.sort(rng.random((ws.n_out, bins - 1)), 1)
                              .astype(np.float32)),
            jstageir.LUTGather(rng.random((ws.n_out, bins, 2))
                               .astype(np.float32)),
            jstageir.Reduce("argmax")])

    mat_pipe = StatefulPipeline(mat(8), backend="interpret", device="cpu")
    assert PacketServeEngine(mat_pipe, feature_dim=4, backend="cuda",
                             device="cpu").backend == "cpu-ref-fused-flow"
    wide = StatefulPipeline(mat(1100), backend="interpret", device="cpu")
    with pytest.raises(ValueError, match="bins > 1024"):
        PacketServeEngine(wide, feature_dim=4, backend="cuda", device="cpu")
    mitigated = case["tstages"] + [convert.stages_from_reference(
        [jstageir.Mitigate(MitigationSpec(n_slots=N_SLOTS, threshold=3))])[0]]
    assert StatefulPipeline(mitigated, backend="cuda", device="cpu"
                            ).backend == "cpu-ref-fused-flow"


# ------------------------------------------ slice 2: the three pipelines


def _mat_suffix(n_in, use_min=False):
    rng = np.random.default_rng(7)
    edges = np.sort(rng.random((n_in, 7)).astype(np.float32), axis=1)
    edges[0] = np.arange(1.0, 8.0, dtype=np.float32)
    tables = rng.random((n_in, 8, 4)).astype(np.float32)
    return [jstageir.Quantize(edges), jstageir.LUTGather(tables),
            jstageir.Reduce("argmin" if use_min else "argmax"),
            jstageir.LabelMap(np.asarray([0, 1, 1, 0], np.int32))]


def _three_pipelines(case):
    """mat-fused, mitigate-fused (benchmarks/flow_throughput.py:58-80)
    and the attack/defense shape (benchmarks/attack_defense.py:47-61,
    seeded MLP), at this file's small table."""
    base = case["jstages"][:3]
    mat = base + _mat_suffix(base[2].n_out)
    train = jtraffic.make_stream("ddos_burst", n_packets=N_PACKETS, seed=0)
    mu, sd = readout_moments(case["tstages"][:3], train.packets)
    detector = jtraffic.fold_input_standardization(case["jstages"][3:], mu,
                                                   sd)
    return {
        "mat-fused": mat,
        "mitigate-fused": mat + [jstageir.Mitigate(
            MitigationSpec(n_slots=N_SLOTS, threshold=6))],
        "attack-defense": base + detector + [jstageir.Mitigate(
            MitigationSpec(n_slots=2 * N_SLOTS, threshold=8))],
    }


@pytest.mark.parametrize("name", ["mat-fused", "mitigate-fused",
                                  "attack-defense"])
@pytest.mark.parametrize("fuse", [True, False])
def test_slice_pipelines_match_reference_engine(case, name, fuse):
    """Each pipeline through the JAX engine (``backend="pallas"``) and
    the port's (``backend="cuda"`` on the CPU), depth 2, a ragged tail:
    the verdict stream (MITIGATED included) and every table equal bit for
    bit (the MLP rows of the random detector hold no margin rows, checked
    in ``test_torch_mitigation``), and the backend names match."""
    jstages = _three_pipelines(case)[name]
    jp = JPipeline(jstages, backend="pallas", fuse=fuse)
    jeng = JEngine(jp, feature_dim=4, max_batch=MAX_BATCH, depth=2,
                   telemetry=False)
    jv = np.concatenate(list(jeng.serve_stream(case["stream"].chunks(CHUNK))))
    tp = StatefulPipeline(convert.stages_from_reference(jstages),
                          backend="cuda", fuse=fuse, device="cpu")
    teng = PacketServeEngine(tp, feature_dim=4, max_batch=MAX_BATCH,
                             depth=2, device="cpu")
    tv = np.concatenate(list(teng.serve_stream(case["stream"].chunks(CHUNK))))
    np.testing.assert_array_equal(tv, jv)
    keys, regs = convert.state_to_numpy(teng.state)
    np.testing.assert_array_equal(keys, np.asarray(jeng.state.keys))
    np.testing.assert_array_equal(regs.view(np.int32),
                                  np.asarray(jeng.state.regs).view(np.int32))
    want = jp.backend.replace("pallas", "cpu-ref")
    assert teng.stats()["backend"] == want
    if name != "mat-fused":
        mk, mr = convert.mitigation_to_numpy(teng.state)
        np.testing.assert_array_equal(mk, np.asarray(jeng.state.mit_keys))
        np.testing.assert_array_equal(mr, np.asarray(jeng.state.mit_regs))
        assert teng.stats()["mitigated"] == int((tv == -1).sum()) > 0
        r = traffic.reaction_report(case["stream"], tv)
        assert r == jtraffic.reaction_report(case["stream"], jv)
