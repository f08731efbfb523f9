"""Port parity: the online loop — ``flowstate.drift`` (``DriftSnapshot``,
``DriftDetector``) and ``serve.online`` (``BackgroundRetrainer``,
``HotSwapController``) — against the JAX package's, on the CPU, and the
threading repairs the loop needs on the card.

* drift: on the same packet windows both detectors give the same score
  sequence (float64 equality: the window means are float32 and the EWMA
  float64 in both) and fire at the same window; the reference's
  degenerate-stream, patience and re-arm cases
  (``tests/test_hot_swap.py:326-351``) hold for the port.
* online: the JAX controller on the JAX engine and the port's on a CPU
  engine, each ``retrain_fn`` returning the same prebuilt pipeline
  (carried across by ``convert``), give the same episodes, swaps,
  journal kinds in order and ``report()`` keys, and the same verdicts;
  a raising ``retrain_fn`` lands in ``errors`` and serving goes on with
  the old model (``:354-400``), a ``SystemExit`` or ``KeyboardInterrupt``
  too, as the reference's worker catches ``BaseException``.
* the engine under the loop: its batch metrics are live before any
  flush, and a flush-per-batch engine ends the stream with the same
  snapshot; a pipeline a swap retires lives until the verdicts of its
  in-flight batches are fetched.
* threads: ``mlalgos._Replayed`` captures with
  ``capture_error_mode="thread_local"`` (checked by recording the call:
  there is no card here); ``kernels._ext.extension()`` builds once
  when two threads ask, and ``count_launch`` loses no count under
  contention (a stubbed ``load``, a shortened switch interval)."""

import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import DriftDetector as JDetector  # noqa: E402
from repro.flowstate import DriftSnapshot as JSnapshot  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.serve import HotSwapController as JController  # noqa: E402
from repro.serve import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.flowstate import DriftDetector, DriftSnapshot  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BackgroundRetrainer,
    HotSwapController,
    PacketServeEngine,
)
from repro_torch.testing import random_mlp  # noqa: E402

WINDOW = 256
N_SLOTS = 128


def _drift_stream(seed=1, n=12_000):
    return jtraffic.make_stream("concept_drift", n_packets=n, seed=seed)


def _windows(stream):
    return [c for c in stream.chunks(WINDOW)]


def _phase_a(stream):
    cut = int(np.searchsorted(stream.times, 120.0 * jtraffic.DRIFT_FRAC))
    return stream.packets[:cut]


# ------------------------------------------------------------------ drift


@pytest.mark.parametrize("cols", [(1,), (1, 2), (0, 1, 2, 3)])
@pytest.mark.parametrize("window", [64, 256, 10_000])
def test_snapshot_matches_reference(cols, window):
    pkts = _phase_a(_drift_stream(seed=0))
    a = JSnapshot.from_packets(pkts, cols=cols, window=window)
    b = DriftSnapshot.from_packets(pkts, cols=cols, window=window)
    assert a.cols == b.cols
    for x, y in ((a.mu, b.mu), (a.sd, b.sd)):
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


@pytest.mark.parametrize("params", [dict(alpha=0.25, threshold=1.9,
                                         patience=3),
                                    dict(alpha=1.0, threshold=0.5,
                                         patience=1),
                                    dict(alpha=0.1, threshold=6.0,
                                         patience=5)])
def test_detector_scores_and_firing_match_reference(params):
    train = _phase_a(_drift_stream(seed=0))
    snaps = (JSnapshot.from_packets(train, cols=(1,), window=WINDOW),
             DriftSnapshot.from_packets(train, cols=(1,), window=WINDOW))
    dets = (JDetector(snaps[0], **params), DriftDetector(snaps[1], **params))
    fired = [None, None]
    for i, w in enumerate(_windows(_drift_stream(seed=1))):
        scores = [d.update(w) for d in dets]
        assert scores[0] == scores[1], i          # float64 equality
        assert dets[0]._ewma.dtype == dets[1]._ewma.dtype == np.float64
        for k, d in enumerate(dets):
            if d.fired and fired[k] is None:
                fired[k] = i
        assert dets[0].report() == dets[1].report()
    assert fired[0] == fired[1]
    if params["threshold"] < 2:
        assert fired[1] is not None


def test_snapshot_degenerate_streams_never_nan():
    short = np.ones((3, 4), np.float32)
    snap = DriftSnapshot.from_packets(short, cols=(1, 2), window=100)
    assert not np.isnan(snap.mu).any() and (snap.sd > 0).all()
    ref = JSnapshot.from_packets(short, cols=(1, 2), window=100)
    assert np.array_equal(snap.mu, ref.mu) and np.array_equal(snap.sd,
                                                               ref.sd)
    empty = np.zeros((0, 4), np.float32)
    snap = DriftSnapshot.from_packets(empty, cols=(1,), window=10)
    assert not np.isnan(snap.mu).any() and (snap.sd > 0).all()


def test_detector_needs_patience_and_rearms():
    base = np.zeros((400, 3), np.float32)
    snap = DriftSnapshot.from_packets(base, cols=(0, 1), window=100)
    det = DriftDetector(snap, alpha=1.0, threshold=0.5, patience=3)
    hot = np.full((100, 3), 50.0, np.float32)
    cold = np.zeros((100, 3), np.float32)
    for w in (hot, hot, cold, hot, hot, cold):
        det.update(w)
    assert not det.fired
    for w in (hot, hot, hot):
        det.update(w)
    assert det.fired
    det.reset()
    assert not det.fired and det.score == 0.0 and det.windows == 0
    assert det.update(np.zeros((0, 3), np.float32)) == 0.0   # empty window
    assert det.windows == 0
    with pytest.raises(ValueError, match="alpha"):
        DriftDetector(snap, alpha=0.0)


# ----------------------------------------------------------------- online


def _stages(seed):
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    return [fk, ru, ws,
            jstageir.FusedMLP(*random_mlp((ws.n_out, 16, 2), seed=seed)),
            jstageir.Reduce("argmax")]


def _controller_run(make_pipe, make_engine, make_detector, controller_cls):
    """Serve the drifting stream under a controller whose retrain returns
    the prebuilt "new" pipeline, held open until the stream is served so
    one episode covers it; then install at a flush and serve on."""
    old, new = make_pipe(_stages(0)), make_pipe(_stages(1))
    eng = make_engine(old)
    release = threading.Event()
    seen = []

    def retrain(ws):
        seen.append(len(ws))
        release.wait(60)
        return new

    ctrl = controller_cls(eng, make_detector(), retrain, buffer_windows=6)
    stream = _drift_stream(seed=1)
    out = []
    for w in _windows(stream):
        ctrl.observe(w)
        eng.submit(w)
        out.append(np.asarray(eng.flush()))
    running = ctrl.retraining
    release.set()
    assert ctrl.wait(60)
    eng.flush()
    tail = _drift_stream(seed=2, n=1000).packets
    eng.submit(tail)
    out.append(np.asarray(eng.flush()))
    kinds = [e["kind"] for e in eng.telemetry().journal.events()]
    return ctrl, eng, np.concatenate(out), kinds, seen, running


def _detector_factory(snapshot_cls, detector_cls):
    train = _phase_a(_drift_stream(seed=0))

    def make():
        snap = snapshot_cls.from_packets(train, cols=(1,), window=WINDOW)
        return detector_cls(snap, alpha=0.25, threshold=1.9, patience=3)
    return make


def test_controller_matches_reference():
    j = _controller_run(
        lambda st: JPipeline(st),
        lambda p: JEngine(p, feature_dim=4, max_batch=WINDOW, depth=2),
        _detector_factory(JSnapshot, JDetector), JController)
    t = _controller_run(
        lambda st: StatefulPipeline(convert.stages_from_reference(st),
                                    backend="cuda", device="cpu"),
        lambda p: PacketServeEngine(p, feature_dim=4, max_batch=WINDOW,
                                    depth=2, device="cpu"),
        _detector_factory(DriftSnapshot, DriftDetector), HotSwapController)
    (jc, je, jv, jk, jseen, jrun), (tc, te, tv, tk, tseen, trun) = j, t
    assert jrun and trun                      # the episode spanned the stream
    assert tc.episodes == jc.episodes == 1
    assert tc.swapped == jc.swapped == 1 and not tc.errors and not jc.errors
    assert tseen == jseen == [6]
    assert tk == jk
    assert tk.count("hot_swap") == 1 and "drift" in tk
    assert tk.index("drift") < tk.index("retrain_start") \
        < tk.index("retrain_done") < tk.index("hot_swap")
    tr, jr = tc.report(), jc.report()
    assert list(tr) == list(jr)
    for k in ("score", "threshold", "windows", "fired", "episodes",
              "swapped", "retraining", "errors"):
        assert tr[k] == jr[k], k
    assert te.stats_.swaps == je.stats_.swaps == 1
    assert te.stats_.swap_pkt_offsets == je.stats_.swap_pkt_offsets
    np.testing.assert_array_equal(tv, jv)
    assert not tc.detector.fired              # re-armed after the swap


def test_controller_captures_retrain_errors_and_serving_goes_on():
    pipe = StatefulPipeline(convert.stages_from_reference(_stages(0)),
                            backend="cuda", device="cpu")
    eng = PacketServeEngine(pipe, feature_dim=4, max_batch=64,
                            device="cpu")
    snap = DriftSnapshot.from_packets(np.zeros((200, 4), np.float32),
                                      cols=(1,), window=100)
    det = DriftDetector(snap, alpha=1.0, threshold=0.5, patience=1)

    def boom(_ws):
        raise RuntimeError("search exploded")

    ctrl = HotSwapController(eng, det, boom)
    ctrl.observe(np.full((50, 4), 9.0, np.float32))
    assert ctrl.wait(60)
    assert ctrl.episodes == 1 and ctrl.swapped == 0
    assert len(ctrl.errors) == 1
    rows = _drift_stream(seed=3, n=300).packets
    eng.submit(rows)
    assert len(eng.flush()) == 300
    assert eng.stats_.swaps == 0 and eng.pipeline is pipe
    blob = json.dumps(ctrl.report())
    assert "search exploded" in blob
    kinds = [e["kind"] for e in eng.telemetry().journal.events()]
    assert kinds[-3:] == ["drift", "retrain_start", "retrain_done"]
    (done,) = eng.telemetry().journal.events("retrain_done")
    assert done["ok"] is False and "search exploded" in done["error"]


@pytest.mark.parametrize("exc", [SystemExit, KeyboardInterrupt])
def test_a_base_exception_in_the_retrain_is_an_error_not_a_swap(exc):
    """A ``SystemExit`` or ``KeyboardInterrupt`` raised in ``retrain_fn``
    ends the episode as an error, as the reference records it: no swap
    counted or parked, one error, ``retrain_done`` with ``ok=False`` and
    the detector left fired (not re-armed)."""
    def run(pipe, make_engine, snapshot_cls, detector_cls, controller_cls):
        eng = make_engine(pipe)
        snap = snapshot_cls.from_packets(np.zeros((200, 4), np.float32),
                                         cols=(1,), window=100)
        det = detector_cls(snap, alpha=1.0, threshold=0.5, patience=1)

        def stop(_ws):
            raise exc("retrain stopped")

        ctrl = controller_cls(eng, det, stop)
        ctrl.observe(np.full((50, 4), 9.0, np.float32))
        assert ctrl.wait(60)
        return ctrl, eng

    j = run(JPipeline(_stages(0)),
            lambda p: JEngine(p, feature_dim=4, max_batch=64),
            JSnapshot, JDetector, JController)
    t = run(StatefulPipeline(convert.stages_from_reference(_stages(0)),
                             backend="cuda", device="cpu"),
            lambda p: PacketServeEngine(p, feature_dim=4, max_batch=64,
                                        device="cpu"),
            DriftSnapshot, DriftDetector, HotSwapController)
    for ctrl, eng in (j, t):
        assert ctrl.episodes == 1 and ctrl.swapped == 0
        assert len(ctrl.errors) == 1 and isinstance(ctrl.errors[0], exc)
        assert not eng.swap_pending and ctrl.detector.fired
        (done,) = eng.telemetry().journal.events("retrain_done")
        assert done["ok"] is False and "retrain stopped" in done["error"]
    assert t[0].report()["errors"] == j[0].report()["errors"]
    assert t[0].report()["swapped"] == j[0].report()["swapped"] == 0
    rows = _drift_stream(seed=3, n=300).packets
    t[1].submit(rows)
    assert len(t[1].flush()) == 300 and t[1].stats_.swaps == 0


def test_retrainer_runs_on_a_worker_and_swaps():
    pipe = StatefulPipeline(convert.stages_from_reference(_stages(0)),
                            backend="cuda", device="cpu")
    new = StatefulPipeline(convert.stages_from_reference(_stages(1)),
                           backend="cuda", device="cpu")
    eng = PacketServeEngine(pipe, feature_dim=4, max_batch=64,
                            device="cpu")
    main = threading.get_ident()
    where = []

    def fn(ws):
        where.append(threading.get_ident())
        return new

    done = []
    w = BackgroundRetrainer(eng, fn, [np.zeros((4, 4), np.float32)],
                            on_done=done.append).start()
    w.join(60)
    assert not w.running and w.error is None and w.result is new
    assert where and where[0] != main and done == [w]
    assert eng.swap_pending
    eng.flush()
    assert eng.pipeline is new and eng.stats_.swaps == 1


# ------------------------------------------- the engine under the loop


def _snapshot_values(eng):
    """Counter and gauge values, histogram counts and sums."""
    out = {}
    for name, m in eng.telemetry().snapshot().items():
        for v in m["values"]:
            key = (name, tuple(sorted(v["labels"].items())))
            out[key] = (v["count"], v["sum"]) if m["kind"] == "histogram" \
                else v["value"]
    return out


def test_batch_metrics_are_live_before_a_flush():
    rows = _drift_stream(seed=4, n=3000).packets

    def engine():
        eng = PacketServeEngine(
            StatefulPipeline(convert.stages_from_reference(_stages(0)),
                             backend="cuda", device="cpu"),
            feature_dim=4, max_batch=128, device="cpu")
        eng.TELEMETRY_SEG_SAMPLE = 1
        return eng

    a, b = engine(), engine()
    a.submit(rows[:640])
    for _ in range(5):
        a._dispatch_batch(a._take(128))
    live = _snapshot_values(a)
    assert live[("serve_packets_total", ())] == 640
    assert live[("serve_batches_total", ())] == 5
    assert live[("serve_dispatch_ms", ())][0] == 5
    a.flush()
    a.submit(rows[640:])
    a.flush()
    for lo in range(0, len(rows), 128):     # the same batches, one a flush
        b.submit(rows[lo:lo + 128])
        b.flush()
    got, want = _snapshot_values(a), _snapshot_values(b)
    assert want[("serve_packets_total", ())] == 3000
    assert got.keys() == want.keys()
    for key, v in want.items():
        if key[0] in ("serve_dispatch_ms", "serve_batch_latency_ms"):
            assert got[key][0] == v[0], key     # host times differ
        elif key[0] not in ("flow_inserts_total", "flow_evictions_total"):
            assert got[key] == v, key           # scans at other flushes


def test_retired_pipeline_lives_until_its_batches_are_fetched():
    """A swap that installs while batches of the old pipeline are in
    flight keeps that pipeline until their verdicts are fetched: on the
    card its memory (allocated on a retrain worker's stream) is not
    handed back while the serving stream may still read it."""
    import gc
    import weakref

    rows = _drift_stream(seed=5, n=1024).packets
    old = StatefulPipeline(convert.stages_from_reference(_stages(0)),
                           backend="cuda", device="cpu")
    new = StatefulPipeline(convert.stages_from_reference(_stages(1)),
                           backend="cuda", device="cpu")
    eng = PacketServeEngine(old, feature_dim=4, max_batch=128, depth=2,
                            device="cpu")
    gone = weakref.ref(old)
    del old
    eng.submit(rows)
    eng._dispatch_batch(eng._take(128))
    eng._dispatch_batch(eng._take(128))
    eng.swap(new)
    eng._dispatch_batch(eng._take(128))     # the install, then new's batch
    assert eng.pipeline is new and eng.stats_.swaps == 1
    gc.collect()
    assert gone() is not None               # two batches still in flight
    eng._fetch_one()
    gc.collect()
    assert gone() is not None               # one still in flight
    eng._fetch_one()
    gc.collect()
    assert gone() is None                   # fetched: released
    assert len(eng.flush()) == len(rows) - 3 * 128 + 128


# -------------------------------------------------------- threading repairs


def test_replayed_captures_thread_local(monkeypatch):
    """The trainer's graph capture must not make the serving thread's
    event waits and allocations illegal: ``thread_local``."""
    from repro_torch.core import mlalgos

    calls = []

    class FakeGraph:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    class FakeCapture:
        def __init__(self, graph, **kw):
            calls.append(kw)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    ran = []
    r = mlalgos._Replayed(lambda: ran.append(1))
    r.WARMUP = 0
    r()
    r()
    assert calls == [{"capture_error_mode": "thread_local"}]
    assert ran == [1] and r.graph.replays == 2


def test_extension_builds_once_from_two_threads(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    from repro_torch.kernels import _ext

    builds = []

    def load(**kw):
        builds.append(kw["name"])
        time.sleep(0.2)
        return object()

    monkeypatch.setattr(cpp, "load", load)
    monkeypatch.setattr(_ext, "_EXT", None)
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "torch_kernels")
    got = []
    threads = [threading.Thread(target=lambda: got.append(_ext.extension()))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert builds == ["repro_torch_kernels"]
    assert len(got) == 4 and all(g is got[0] for g in got)


def test_count_launch_loses_no_count_under_contention(monkeypatch):
    from repro_torch.kernels import _ext

    monkeypatch.setattr(_ext, "LAUNCHES", dict(_ext.LAUNCHES))
    _ext.reset_launches()
    n_threads, per = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _ext.count_launch("flow_update") for _ in range(per)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert _ext.LAUNCHES["flow_update"] == n_threads * per
