"""Port parity: the rest of ``data/traffic.py`` — ``PacketStream.slice``,
the topology-aware streams (``switch_of_flow``, ``switch_streams``,
``compose_streams``), ``windowed_flow_stats``, ``auto_label`` and
``stream_feature_dataset`` — against the JAX package's, on the CPU.

Tolerance: Exact.  The stream functions are numpy copies of the
reference's arithmetic (the Knuth mix in uint32, stable argsorts,
``bincount`` order), so every array is equal element for element and
every dict key for key.  ``stream_feature_dataset(device="cpu")``
replays through the port's split path (K2's plain version, the
WindowStats readout) where the reference replays through its
``interpret`` engine: ``train_x``, ``test_x``, ``mu`` and ``sd`` are the
same bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import traffic as jt  # noqa: E402

from repro_torch.data import traffic as tt  # noqa: E402

N_PACKETS = 3000


def _streams(scenario, seed=0, n=N_PACKETS):
    return (jt.make_stream(scenario, n_packets=n, seed=seed),
            tt.make_stream(scenario, n_packets=n, seed=seed))


def _same_stream(a, b):
    assert a.scenario == b.scenario
    for f in ("packets", "labels", "flow_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f
    assert a.flow_labels == b.flow_labels
    assert (a.times is None) == (b.times is None)
    if a.times is not None:
        assert np.array_equal(a.times, b.times)


def _same_dict(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("scenario", jt.SCENARIOS)
@pytest.mark.parametrize("window", [(0, 1000), (700, None), (2999, 3005),
                                    (1500, 1500)])
def test_slice_matches_reference(scenario, window):
    j, t = _streams(scenario)
    _same_stream(j.slice(*window), t.slice(*window))


@pytest.mark.parametrize("n_switches", [1, 2, 3, 4, 7])
def test_switch_of_flow_matches_reference(n_switches):
    ids = np.random.default_rng(n_switches).integers(0, 1 << 22, 5000)
    a = jt.switch_of_flow(ids, n_switches)
    b = tt.switch_of_flow(ids, n_switches)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("scenario", jt.SCENARIOS)
@pytest.mark.parametrize("n_switches", [1, 3, 4])
def test_switch_and_compose_streams_match_reference(scenario, n_switches):
    j, t = _streams(scenario, seed=n_switches)
    js, ts = jt.switch_streams(j, n_switches), tt.switch_streams(t, n_switches)
    assert len(js) == len(ts) == n_switches
    for a, b in zip(js, ts):
        _same_stream(a, b)
    _same_stream(jt.compose_streams(js), tt.compose_streams(ts))
    _same_stream(jt.compose_streams(js, scenario="x"),
                 tt.compose_streams(ts, scenario="x"))


def test_stream_refusals_match_reference():
    _, t = _streams("benign")
    with pytest.raises(ValueError, match="n_switches"):
        tt.switch_streams(t, 0)
    with pytest.raises(ValueError, match="at least one"):
        tt.compose_streams([])
    bare = tt.PacketStream("x", t.packets, t.labels, t.flow_ids,
                           t.flow_labels)
    with pytest.raises(ValueError, match="timestamped"):
        tt.compose_streams([bare])
    with pytest.raises(ValueError, match="timestamped"):
        tt.windowed_flow_stats(bare)


@pytest.mark.parametrize("scenario", jt.SCENARIOS)
@pytest.mark.parametrize("window_s", [0.5, 1.0, 7.0])
def test_windowed_flow_stats_and_auto_label_match_reference(scenario,
                                                             window_s):
    j, t = _streams(scenario, seed=3)
    a = jt.windowed_flow_stats(j, window_s=window_s)
    b = tt.windowed_flow_stats(t, window_s=window_s)
    _same_dict(a, b)
    assert jt.auto_label(a) == tt.auto_label(b)
    assert jt.auto_label(a, flood_ipt_s=2e-3, volume_min_pkts=100) == \
        tt.auto_label(b, flood_ipt_s=2e-3, volume_min_pkts=100)


def test_windowed_flow_stats_of_an_empty_stream():
    j, t = _streams("benign")
    _same_dict(jt.windowed_flow_stats(j.slice(0, 0)),
               tt.windowed_flow_stats(t.slice(0, 0)))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kw", [dict(), dict(sample_every=3, test_frac=0.2,
                                             chunk=256, seed=5)])
def test_stream_feature_dataset_matches_reference_bit_for_bit(kw):
    """A 2,000-packet concept_drift stream through both replays: the same
    train/test features, labels and moments, bit for bit."""
    j, t = _streams("concept_drift", n=2000)
    jst, jnames = jt.flow_feature_stages(n_slots=256)
    tst, tnames = tt.flow_feature_stages(n_slots=256)
    jds, jmu, jsd = jt.stream_feature_dataset(j, jst, jnames, **kw)
    tds, tmu, tsd = tt.stream_feature_dataset(t, tst, tnames, device="cpu",
                                              **kw)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        _same_bits(getattr(jds, f), getattr(tds, f))
    _same_bits(jmu, tmu)
    _same_bits(jsd, tsd)
    assert tds.name == jds.name and tds.feature_names == jds.feature_names
    assert tds.num_classes == jds.num_classes == 2
    assert len(tds.train_x) + len(tds.test_x) > 0


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_stream_feature_dataset_degenerate_streams(n):
    """The reference's degenerate guards (``traffic.py:392-414``): both
    splits non-empty from two rows on, one row its own train and test,
    zero rows with identity moments, never NaN."""
    j, t = _streams("ddos_burst", n=50)
    jst, jnames = jt.flow_feature_stages(n_slots=64)
    tst, tnames = tt.flow_feature_stages(n_slots=64)
    jds, jmu, jsd = jt.stream_feature_dataset(j.slice(0, n), jst, jnames,
                                              sample_every=1)
    tds, tmu, tsd = tt.stream_feature_dataset(t.slice(0, n), tst, tnames,
                                              sample_every=1, device="cpu")
    for f in ("train_x", "train_y", "test_x", "test_y"):
        _same_bits(getattr(jds, f), getattr(tds, f))
    _same_bits(jmu, tmu)
    _same_bits(jsd, tsd)
    assert not np.isnan(tmu).any() and not np.isnan(tsd).any()


def test_features_only_pipeline_serves_the_readout():
    """``StatefulPipeline(prefix, backend="cuda", fuse=False)`` with no
    classifier serves the WindowStats readout as the split path computes
    it (K2, then the readout's plain version), reported like the JAX
    package's features-only pipeline: "mixed"."""
    from repro.flowstate import StatefulPipeline as JPipeline

    from repro_torch.flowstate import StatefulPipeline

    jst, _ = jt.flow_feature_stages(n_slots=128)
    tst, _ = tt.flow_feature_stages(n_slots=128)
    sp = StatefulPipeline(list(tst), backend="cuda", fuse=False,
                          device="cpu")
    assert sp.flow_backend == "cpu-ref"
    assert sp.classifier_backend == "interpret"
    assert JPipeline(list(jst), backend="pallas",
                     fuse=False).classifier_backend == "interpret"
    with pytest.raises(ValueError, match="fused"):
        StatefulPipeline(list(tst), backend="cuda", fuse=True, device="cpu")
