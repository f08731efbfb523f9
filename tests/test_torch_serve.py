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


# ----------------------------------- slice 3: stateless serving and DAGs

D_FEAT, D_BATCH, D_PACKETS, D_CHUNK = 7, 128, 1000, 97


def _jpseudo(stages):
    class _P:                            # minimal reference pipeline
        def __init__(self, s):
            self.stages = s

        def __call__(self, x):
            import jax.numpy as jnp

            return np.asarray(jstageir.apply_stages(
                self.stages, jnp.asarray(x, jnp.float32)))

    return _P(stages)


@pytest.fixture(scope="module")
def dag_case():
    """The AD DAG's seeded models (``testing.ad_pipelines``' weights) as
    reference pipelines and their port counterparts, and a packet batch
    on the AD test set's scale."""
    from repro.core.alchemy import Model as JModel

    from repro_torch.testing import AD_WIDTHS, he_mlp

    svm_w, svm_b = he_mlp((D_FEAT, 2), 1)
    cent = np.random.default_rng(100).normal(size=(4, D_FEAT)).astype(
        np.float32)
    jp = {"ad": _jpseudo([jstageir.FusedMLP(*he_mlp(AD_WIDTHS, 0)),
                          jstageir.Reduce("argmax")]),
          "tc": _jpseudo([jstageir.Dense(svm_w[0], svm_b[0]),
                          jstageir.Reduce("argmax")]),
          "cl": _jpseudo([jstageir.CentroidDistance(cent),
                          jstageir.Reduce("argmin"),
                          jstageir.LabelMap(np.asarray([0, 1, 0, 1],
                                                       np.int32))])}
    from repro.data import netdata

    X = netdata.make_ad_dataset(features=7, n_train=256,
                                n_test=D_PACKETS).test_x
    m = {k: JModel({"name": k, "data_loader": lambda: None,
                    "algorithm": None}) for k in jp}
    return {"jp": jp, "tp": convert.pipelines_from_reference(jp,
                                                             device="cpu"),
            "X": X.astype(np.float32), "jm": m}


def _tnode(dc, text):
    jm = dc["jm"]
    jnode = {"ad>tc": jm["ad"] > jm["tc"],
             "ad>(tc|cl)": jm["ad"] > (jm["tc"] | jm["cl"])}[text]
    return jnode, convert.dag_from_reference(jnode)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("what", ["fused-dag", "per-model", "mixed",
                                  "stages"])
def test_stateless_engine_keeps_arrival_order(dag_case, depth, what):
    """Ragged chunks through the stateless engine at depth 1-3: verdicts
    in arrival order, equal to the whole batch through the same program
    and, under the margin rule, to the JAX engine's; pads sliced off."""
    from repro.core import chaining as jchaining
    from repro.serve.packet_engine import PacketServeEngine as JEng

    from repro_torch.core import chaining
    from repro_torch.testing import leaf_margin_rows

    X = dag_case["X"]
    if what == "stages":
        prog = dag_case["tp"]["ad"]
        jprog = dag_case["jp"]["ad"]
        want_backend, leaves = "cpu-ref", [dag_case["tp"]["ad"]]
        kw = {"backend": "cuda"}
    else:
        text = "ad>(tc|cl)" if what == "mixed" else "ad>tc"
        jnode, tnode = _tnode(dag_case, text)
        prog = chaining.compile_dag(tnode, dag_case["tp"], backend="cuda",
                                    fuse_dag=what != "per-model",
                                    device="cpu")
        jprog = jchaining.compile_dag(jnode, dag_case["jp"],
                                      backend="pallas",
                                      fuse_dag=what != "per-model")
        want_backend = {"fused-dag": "cpu-ref-fused-dag",
                        "per-model": "cpu-ref", "mixed": "mixed"}[what]
        leaves = [dag_case["tp"][m.name] for m in tnode.leaves()]
        kw = {}
    eng = PacketServeEngine(prog, feature_dim=D_FEAT, max_batch=D_BATCH,
                            depth=depth, device="cpu", **kw)
    chunks = [X[i:i + D_CHUNK] for i in range(0, len(X), D_CHUNK)]
    got = np.concatenate(list(eng.serve_stream(chunks)))
    whole = prog(X)
    np.testing.assert_array_equal(got, whole)
    jeng = JEng(jprog, feature_dim=D_FEAT, max_batch=D_BATCH, depth=depth,
                telemetry=False, **({"backend": "pallas"} if kw else {}))
    jv = np.concatenate(list(jeng.serve_stream(chunks)))
    close = leaf_margin_rows(leaves, X)
    assert int(((got != jv) & ~close).sum()) == 0
    st = eng.stats()
    assert st["backend"] == want_backend and eng.backend == want_backend
    assert st["packets"] == D_PACKETS and st["batches"] == -(-D_PACKETS //
                                                             D_BATCH)
    assert st["pad_packets"] == D_BATCH - D_PACKETS % D_BATCH
    assert got.dtype == np.int32 and got.shape == (D_PACKETS,)


def test_stateless_engine_rejects_wrong_width_and_serves_logits(dag_case):
    from repro_torch.core import stageir

    eng = PacketServeEngine(dag_case["tp"]["ad"], feature_dim=D_FEAT,
                            max_batch=64, device="cpu")
    with pytest.raises(ValueError, match="features"):
        eng.submit(np.zeros((3, D_FEAT + 1), np.float32))
    logits = stageir.StagePipeline(dag_case["tp"]["ad"].stages[:1],
                                   device="cpu")
    eng = PacketServeEngine(logits, feature_dim=D_FEAT, max_batch=64,
                            backend="cuda", device="cpu")
    eng.submit(dag_case["X"][:150])
    out = eng.flush()
    assert out.shape == (150, 2) and out.dtype == np.float32
    np.testing.assert_array_equal(
        out, logits(torch.as_tensor(dag_case["X"][:150])))
    # the verdict ring is sized at warm-up and again at a swap, so the
    # dispatch never allocates one
    assert {(tuple(t.shape), t.dtype) for t in eng._out_staging} \
        == {((64, 2), torch.float32)}
    eng.swap(dag_case["tp"]["ad"])
    eng.submit(dag_case["X"][:70])
    np.testing.assert_array_equal(eng.flush(),
                                  dag_case["tp"]["ad"](dag_case["X"][:70]))
    assert {(tuple(t.shape), t.dtype) for t in eng._out_staging} \
        == {((64,), torch.int32)}
    # a bare callable serves as given; backend="cuda" has no stage list
    # to lower and is refused, never quietly served plain
    with pytest.raises(ValueError, match="stage list"):
        PacketServeEngine(lambda x: x, feature_dim=D_FEAT, backend="cuda",
                          device="cpu")


def test_stateless_swap_at_the_ring_boundary(dag_case):
    """A swap between stateless programs (a DAG to one model's
    pipeline) lands at the ring boundary: verdicts before it are the old
    program's, after it the new one's, and the swap is recorded once."""
    from repro_torch.core import chaining

    X = dag_case["X"]
    _, ab = _tnode(dag_case, "ad>tc")
    old = chaining.compile_dag(ab, dag_case["tp"], backend="cuda",
                               device="cpu")
    new = dag_case["tp"]["tc"]
    eng = PacketServeEngine(old, feature_dim=D_FEAT, max_batch=D_BATCH,
                            depth=2, device="cpu")
    eng.submit(X[:400])
    first = eng.flush()
    eng.swap(new, backend="cuda")
    assert eng.swap_pending
    eng.submit(X[400:])
    second = eng.flush()
    np.testing.assert_array_equal(first, old(X[:400]))
    np.testing.assert_array_equal(second, new(X[400:]))
    assert not np.array_equal(old(X[400:]), second)
    st = eng.stats()
    assert st["swaps"] == 1 and st["swap_pkt_offsets"] == [400]
    assert st["backend"] == "cpu-ref"
    assert st["backend_batches"] == {"cpu-ref-fused-dag": 4, "cpu-ref": 5}


def test_swap_refuses_a_change_of_statefulness(case, dag_case):
    from repro_torch.core import chaining

    _, ab = _tnode(dag_case, "ad>tc")
    dag = chaining.compile_dag(ab, dag_case["tp"], device="cpu")
    stateful = StatefulPipeline(case["tstages"], backend="cuda",
                                device="cpu")
    eng = PacketServeEngine(dag, feature_dim=D_FEAT, device="cpu")
    with pytest.raises(ValueError, match="engine is stateless"):
        eng.swap(stateful)
    seng = PacketServeEngine(stateful, feature_dim=4, device="cpu")
    with pytest.raises(ValueError, match="engine is stateful"):
        seng.swap(dag)
    assert not eng.swap_pending and not seng.swap_pending


# ------------------------------------------------- bare callables, as the
# reference serves them (tests/test_packet_engine.py,
# tests/test_hot_swap.py)

OLD_TAG, NEW_TAG = 0, 1_000_000


def _tagged(n, start=0):
    out = np.zeros((n, 2), np.float32)
    out[:, 0] = np.arange(start, start + n)
    return out


def test_bare_callable_verdicts_survive_buffer_reuse():
    """A callable returning a VIEW of its input keeps the verdicts it
    already returned when the staging ring is reused, and reports
    interpret, as the reference's engine does."""
    for backend in (None, "interpret"):
        eng = PacketServeEngine(lambda x: x[:, 0], feature_dim=2,
                                max_batch=8, depth=2, backend=backend,
                                device="cpu")
        jeng = JEngine(lambda x: x[:, 0], feature_dim=2, max_batch=8,
                       depth=2, backend=backend)
        assert eng.backend == jeng.backend == "interpret"
        eng.submit(_tagged(40))            # 5 batches > ring size (depth+1)
        first = eng.flush()
        np.testing.assert_array_equal(first, np.arange(40))
        eng.submit(np.full((16, 2), 777.0, np.float32))
        eng.flush()
        np.testing.assert_array_equal(first, np.arange(40))
        assert eng.stats()["backend_batches"] == {"interpret": 7}
    with pytest.raises(KeyError, match="backend"):
        PacketServeEngine(lambda x: x[:, 0], feature_dim=2, backend="pallas",
                          device="cpu")


def test_bare_callable_may_return_numpy_or_a_tensor():
    X = _tagged(21)
    outs = []
    for fn in (lambda x: x.numpy()[:, 0].astype(np.int32),
               lambda x: x[:, 0].to(torch.int32)):
        eng = PacketServeEngine(fn, feature_dim=2, max_batch=8,
                                device="cpu")
        eng.submit(X)
        outs.append(eng.flush())
    jeng = JEngine(lambda x: x[:, 0].astype(np.int32), feature_dim=2,
                   max_batch=8)
    jeng.submit(X)
    ref = jeng.flush()
    for out in outs:
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)


def test_swap_between_bare_callables_lands_at_the_boundary():
    """One swap between two callables mid-stream: verdicts before the
    recorded boundary are the old callable's, after it the new one's,
    and none is dropped."""
    old = lambda x: x[:, 0].to(torch.int32) + OLD_TAG  # noqa: E731
    new = lambda x: x[:, 0].to(torch.int32) + NEW_TAG  # noqa: E731
    eng = PacketServeEngine(old, feature_dim=2, max_batch=7, depth=3,
                            device="cpu")
    eng.submit(_tagged(30))
    got = [eng.flush()]
    eng.swap(new)
    assert eng.swap_pending
    eng.submit(_tagged(25, start=30))
    got.append(eng.flush())
    verdicts = np.concatenate(got)
    assert len(verdicts) == 55 and eng.stats_.swaps == 1
    off = eng.stats_.swap_pkt_offsets[0]
    assert off == 30
    tags = np.arange(55)
    np.testing.assert_array_equal(verdicts[:off], tags[:off] + OLD_TAG)
    np.testing.assert_array_equal(verdicts[off:], tags[off:] + NEW_TAG)
    assert eng.backend == "interpret"
    with pytest.raises(ValueError, match="stage list"):
        eng.swap(new, backend="cuda")


def test_bare_callable_threads_state_like_the_reference():
    """``state=`` makes a callable ``(state, X, valid) -> (state,
    verdicts)``: padding rows arrive with valid 0, and the state threads
    through every batch in order, as in the reference's engine."""
    def count(st, X, valid):
        return st + int(np.asarray(valid).sum()), np.asarray(X)[:, 0] * 2

    X = _tagged(29)
    eng = PacketServeEngine(count, feature_dim=2, max_batch=8, state=5,
                            device="cpu", telemetry=False)
    jeng = JEngine(count, feature_dim=2, max_batch=8, state=5,
                   telemetry=False)
    for e in (eng, jeng):
        e.submit(X)
    np.testing.assert_array_equal(eng.flush(), jeng.flush())
    assert eng.state == jeng.state == 5 + 29
    assert eng.stats()["pad_packets"] == jeng.stats()["pad_packets"] == 3
