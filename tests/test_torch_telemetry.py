"""Port parity: the telemetry plane (``repro_torch.telemetry``, a copy of
``repro.telemetry`` that imports nothing of the JAX package) and the
port engine's telemetry hooks, against the JAX package.

The same recordings give the same snapshots, the same Prometheus and
JSON text and the same spans; ``table_health`` and
``batch_segmentation`` equal the JAX functions on the same arrays; and
the port's engine and the JAX engine, serving the same stream on the CPU
with ``TELEMETRY_SEG_SAMPLE = 1``, end with the same counter values, the
same journal kinds in order and the same health gauges, one table or
two, mitigated or not, across hot swaps."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import telemetry as J  # noqa: E402
from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.flowstate import MitigationSpec as JMitSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.serve import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.flowstate import MitigationSpec  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.serve.packet_engine import PacketServeEngine  # noqa: E402
from repro_torch.telemetry.metrics import MetricsRegistry  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    mat_stages,
    random_mlp,
    two_table_stages,
)

N_SLOTS = 64


def _record(m):
    """One sequence of recordings on a registry of either package."""
    c = m.counter("pkts_total", "packets served")
    c.default.inc(3)
    c.inc(2, backend="cuda")
    c.inc(1, backend='a"b\\c')
    m.gauge("occ", "occupancy").default.set(0.25)
    h = m.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.default.observe(v)
    m.histogram("dispatch_ms", "default buckets").default.observe(0.07)
    return m


# ------------------------------------------------------------ the plane


def test_metrics_and_exports_match_reference():
    """The same recordings -> the same snapshot, Prometheus text and JSON
    text as the JAX package's registry."""
    t = _record(MetricsRegistry())
    j = _record(J.metrics.MetricsRegistry())
    assert t.snapshot() == j.snapshot()
    assert T.to_prometheus(t.snapshot()) == J.to_prometheus(j.snapshot())
    assert T.to_json(t.snapshot()) == J.to_json(j.snapshot())
    snap = t.snapshot()
    t.counter("pkts_total").default.inc(100)     # a snapshot is a copy
    assert snap["pkts_total"]["values"][0]["value"] == 3.0


def test_registry_get_or_create_kind_mismatch_and_interned_labels():
    m = MetricsRegistry()
    assert m.counter("x") is m.counter("x")
    with pytest.raises(TypeError):
        m.gauge("x")
    assert m.get("x").kind == "counter" and m.get("missing") is None
    c = m.counter("y")
    assert c.labels(backend="cuda") is c.labels(backend="cuda")
    assert c.labels(backend="cuda") is not c.labels(backend="interpret")


def test_tracer_matches_reference():
    """The same spans, ring bound and Chrome trace events as the JAX
    tracer from one time origin (only the producer's name differs)."""
    tt, jt = T.Tracer(capacity=4), J.Tracer(capacity=4)
    tt.epoch = jt.epoch = 0.0                    # one time origin
    for tr in (tt, jt):
        for i in range(6):
            tr.record(f"s{i}", float(i), float(i) + 0.001, cat="c",
                      args={"i": i})
    assert len(tt) == len(jt) == 4 and tt.dropped == jt.dropped == 2
    key = lambda s: (s.name, s.cat, s.t0, s.dur_s, s.args)  # noqa: E731
    assert [key(s) for s in tt.spans()] == [key(s) for s in jt.spans()]
    a, b = tt.chrome_trace(), jt.chrome_trace()
    assert [{k: v for k, v in e.items() if k != "tid"}
            for e in a["traceEvents"]] == [
        {k: v for k, v in e.items() if k != "tid"}
        for e in b["traceEvents"]]
    assert a["otherData"]["dropped_spans"] == 2
    assert a["otherData"]["producer"] == "repro_torch.telemetry"
    with tt.span("compile", cat="warm", backend="cuda"):
        pass
    s = tt.spans()[-1]
    assert s.name == "compile" and s.args == {"backend": "cuda"}
    json.dumps(tt.chrome_trace())


def test_journal_matches_reference(tmp_path):
    """The same events, fields and order as the JAX journal, a bounded
    ring, and a JSON-lines file that loads back."""
    tj = T.EventJournal(str(tmp_path / "t.jsonl"), capacity=8)
    jj = J.EventJournal(str(tmp_path / "j.jsonl"), capacity=8)
    for jr in (tj, jj):
        for i in range(10):
            jr.emit("drift", i=i)
        jr.emit("hot_swap", lat_ms=1.5, pkt_offset=1024)
        jr.close()
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("t_s", "wall")} for e in evs]
    assert strip(tj.events()) == strip(jj.events())
    assert tj.kinds() == jj.kinds() == {"drift", "hot_swap"}
    on_file = T.EventJournal.load(str(tmp_path / "t.jsonl"))
    assert len(on_file) == 11 and on_file[-8:] == tj.events()
    assert T.EventJournal.load(tj.dump(str(tmp_path / "d.jsonl"))) == \
        tj.events()
    assert set(T.EVENT_KINDS) == set(J.EVENT_KINDS)
    ts = [e["t_s"] for e in tj.events()]
    assert ts == sorted(ts)


class _State:
    def __init__(self, keys, mit=None):
        self.keys = keys
        if mit is not None:
            self.mit_spec, self.mit_keys, self.mit_regs = mit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_health_and_residency_match_reference(seed):
    """``table_health`` on the port's tensors equals the JAX function on
    the same numpy arrays: occupancy, inserts, evictions, action-table
    residency."""
    rng = np.random.default_rng(seed)
    prev = np.where(rng.random(64) < 0.5, rng.integers(0, 9, 64), -1)
    cur = np.where(rng.random(64) < 0.6, rng.integers(0, 9, 64), -1)
    prev, cur = prev.astype(np.int32), cur.astype(np.int32)
    mk = np.where(rng.random(16) < 0.7, rng.integers(0, 99, 16),
                  -1).astype(np.int32)
    mr = rng.integers(0, 5, (16, 2)).astype(np.float32)
    jm = (JMitSpec(n_slots=16, threshold=2), mk, mr)
    tm = (MitigationSpec(n_slots=16, threshold=2), torch.as_tensor(mk),
          torch.as_tensor(mr))
    for p in (None, prev):
        want = J.table_health(_State(cur, jm), p)
        got = T.table_health(_State(torch.as_tensor(cur), tm), p)
        np.testing.assert_array_equal(got.pop("keys"), want.pop("keys"))
        assert got == want
    assert T.mitigation_residency(_State(cur)) == \
        J.mitigation_residency(_State(cur))


@pytest.mark.parametrize("par_rounds", [None, 1, 2, 8])
def test_batch_segmentation_matches_reference(par_rounds):
    """The same chain statistics and drain-heavy flag as the JAX
    function; the default ``PAR_ROUNDS`` is the reference kernel's."""
    from repro.kernels.flow_update.kernel import PAR_ROUNDS

    assert T.flow_health.PAR_ROUNDS == PAR_ROUNDS
    rng = np.random.default_rng(5)
    for slots in (rng.integers(0, 4, 50), rng.integers(0, 64, 50),
                  np.full(40, 3), np.full(16, 7), np.asarray([], np.int64)):
        kw = {} if par_rounds is None else {"par_rounds": par_rounds}
        assert T.batch_segmentation(slots, **kw) == \
            J.batch_segmentation(slots, **kw)


# ------------------------------------------------- the engine, end to end


def _single(suffix="mlp", mit=None, seed=3):
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    cls = (mat_stages(ws.n_out, stageir=jstageir) if suffix == "mat" else
           [jstageir.FusedMLP(*random_mlp((ws.n_out, 16, 2), seed=seed)),
            jstageir.Reduce("argmax")])
    return [fk, ru, ws] + cls + ([jstageir.Mitigate(mit)] if mit else [])


def _two(suffix="mlp", mit=None, seed=0):
    return two_table_stages(jstageir, jtraffic, JSpec, n_slots=N_SLOTS,
                            port_slots=16, suffix=suffix, mitigation=mit,
                            seed=seed)


MIT = JMitSpec(n_slots=N_SLOTS, threshold=3)
ENGINE_CASES = {
    "single": (_single(), []),
    "two_table": (_two(), []),
    "two_table_mitigated": (_two("mat", MIT), []),
    "swaps_single_two_single": (_single("mat", MIT),
                                [_two("mat", MIT), _single("mat", MIT)]),
    "swap_changes_spec": (_two(), [two_table_stages(
        jstageir, jtraffic, JSpec, n_slots=2 * N_SLOTS, port_slots=32)]),
}


def _counters(snap):
    """Every unlabelled counter and gauge, histogram counts, and the
    backend counter's total."""
    out = {}
    for name, m in snap.items():
        if m["kind"] == "histogram":
            out[name] = sum(v["count"] for v in m["values"])
        elif name == "serve_backend_batches_total":
            out[name] = sum(v["value"] for v in m["values"])
        else:
            (v,) = m["values"]
            out[name] = v["value"]
    return out


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_telemetry_matches_reference(case):
    """The port's engine (K1's plain version, ``backend="cuda"`` on the
    CPU) and the JAX engine serve one ddos_burst stream in chunks with a
    flush after each, hot-swapping where the case says: the same
    verdicts, the same counter and gauge values (health scans included),
    the same histogram counts and the same journal kinds in order."""
    first, swaps = ENGINE_CASES[case]
    stream = jtraffic.make_stream("ddos_burst", n_packets=900, seed=6)
    chunks = [stream.packets[i:i + 150] for i in range(0, 900, 150)]

    def run(make_pipe, make_engine):
        eng = make_engine(make_pipe(first))
        eng.TELEMETRY_SEG_SAMPLE = 1
        got = []
        for i, c in enumerate(chunks):
            k = i // 2 - 1
            if i % 2 == 0 and 0 <= k < len(swaps):
                eng.swap(make_pipe(swaps[k]))
            eng.submit(c)
            got.append(np.asarray(eng.flush()))
        return np.concatenate(got), eng

    jv, jeng = run(JPipeline, lambda p: JEngine(p, feature_dim=4,
                                                max_batch=64))
    tv, teng = run(lambda st: StatefulPipeline(
        convert.stages_from_reference(st), device="cpu"),
        lambda p: PacketServeEngine(p, feature_dim=4, max_batch=64,
                                    backend="cuda", device="cpu"))
    np.testing.assert_array_equal(tv, jv)
    tsnap, jsnap = teng.telemetry().snapshot(), jeng.telemetry().snapshot()
    assert set(tsnap) == set(jsnap)
    for name in tsnap:
        assert tsnap[name]["help"] == jsnap[name]["help"], name
    assert _counters(tsnap) == _counters(jsnap)
    assert [e["kind"] for e in teng.telemetry().journal.events()] == \
        [e["kind"] for e in jeng.telemetry().journal.events()]
    assert _counters(tsnap)["serve_packets_total"] == 900
    assert _counters(tsnap)["serve_swaps_total"] == len(swaps)
    names = {s.name for s in teng.telemetry().tracer.spans()}
    assert {"warm_up", "dispatch", "batch"} <= names
    if swaps:
        assert {"swap_prepare", "swap_install"} <= names
    if "mitigated" in case or "swaps" in case:
        assert _counters(tsnap)["serve_mitigated_packets_total"] == \
            int((tv == -1).sum()) > 0


def test_telemetry_false_disables_recording_and_keeps_verdicts():
    rows = jtraffic.make_stream("ddos_burst", n_packets=300, seed=7).packets
    pipe = StatefulPipeline(convert.stages_from_reference(_two()),
                            device="cpu")
    off = PacketServeEngine(pipe, feature_dim=4, max_batch=64,
                            device="cpu", telemetry=False)
    on = PacketServeEngine(pipe, feature_dim=4, max_batch=64, device="cpu")
    assert off.telemetry() is None and on.telemetry() is not None
    off.submit(rows)
    on.submit(rows)
    np.testing.assert_array_equal(off.flush(), on.flush())


def test_shared_plane_aggregates_across_engines():
    tel = T.Telemetry()
    rows = jtraffic.make_stream("ddos_burst", n_packets=100, seed=8).packets
    for _ in range(2):
        eng = PacketServeEngine(StatefulPipeline(
            convert.stages_from_reference(_single()), device="cpu"),
            feature_dim=4, max_batch=32, device="cpu", telemetry=tel)
        assert eng.telemetry() is tel
        eng.submit(rows)
        eng.flush()
    assert tel.snapshot()["serve_packets_total"]["values"][0]["value"] \
        == 200
    assert "serve_packets_total 200" in tel.prometheus()


def test_requested_cuda_with_a_plain_part_is_journaled():
    """``backend="cuda"`` with a part the JAX package has no kernel for
    either (the split path's action table: "mixed") journals a
    ``backend_fallback``, at construction and at a swap, as the JAX
    engine journals a requested "pallas" that serves "mixed"."""
    stages = convert.stages_from_reference(_single("mat", MIT))
    pipe = StatefulPipeline(stages, backend="cuda", fuse=False,
                            device="cpu")
    eng = PacketServeEngine(pipe, feature_dim=4, max_batch=32,
                            backend="cuda", device="cpu")
    assert eng.backend == "mixed"
    (ev,) = eng.telemetry().journal.events("backend_fallback")
    assert ev["requested"] == "cuda" and ev["actual"] == "mixed"
    eng.swap(pipe, backend="cuda")
    evs = eng.telemetry().journal.events("backend_fallback")
    assert len(evs) == 2 and evs[1]["during"] == "swap"
    fused = PacketServeEngine(StatefulPipeline(stages, device="cpu"),
                              feature_dim=4, max_batch=32, backend="cuda",
                              device="cpu")
    assert not fused.telemetry().journal.events("backend_fallback")
    jeng = JEngine(JPipeline(_single("mat", MIT), backend="pallas",
                             fuse=False), feature_dim=4, max_batch=32,
                   backend="pallas")
    assert [e["actual"] for e in jeng.telemetry().journal.events(
        "backend_fallback")] == ["mixed"]


def test_segmentation_is_sampled_from_the_host_rows():
    """Every ``TELEMETRY_SEG_SAMPLE``-th batch (the first included) is
    segmented, from table 0's keys of the real rows."""
    rows = jtraffic.make_stream("ddos_burst", n_packets=640, seed=9).packets
    eng = PacketServeEngine(StatefulPipeline(
        convert.stages_from_reference(_two()), device="cpu"),
        feature_dim=4, max_batch=32, device="cpu")
    assert eng.TELEMETRY_SEG_SAMPLE == 8
    eng.submit(rows)
    eng.flush()
    c = _counters(eng.telemetry().snapshot())
    assert c["serve_batches_total"] == 20
    assert c["flow_lockstep_batches_total"] \
        + c["flow_drain_batches_total"] == 3      # batches 1, 9 and 17
    assert c["flow_occupied_slots"] == int((eng.state.keys >= 0).sum())
