"""Port parity: sharded packet serving (``serve.sharded``) and the flow-
state / traffic names that came with it, on the CPU.

The reference's sharded engine does not run on this jax (its
``shard_map`` step passes ``check_rep``), so the port is held to the
reference's own multi-device oracle (``tests/test_sharded_engine.py``'s
subprocess case): each shard equals its own single-device engine fed
that shard's rows in arrival order.  Here those engines are the JAX
package's ``PacketServeEngine``s, and the shards are ``devices=["cpu"] *
n`` (a device listed n times is n shards, each with its own table):

* ``shard_of_key`` and ``route_prefix`` bit for bit against the
  reference's numpy functions over seeded keys;
* stateful parity at n = 1, 2, 4: per-shard tables (keys, register bits)
  and every verdict equal to the JAX engines fed each shard's rows, for
  the reference test's flow pipeline (feature rows out) fused and split,
  and for the mitigated MAT pipeline (action tables exact);
* stateless parity against the JAX engine on the whole batch, MLP
  verdicts under the margin rule;
* overflow push-back, ragged tails, empty flushes and streams, the
  degrade cases, the swap refusals, a spec-changing swap against the
  reference's ``migrate_state`` / ``migrate_mitigation`` per shard, the
  ``convert`` carry of a reference ``ShardedFlowState``, the shard-folded
  segmentation against the reference's ``batch_segmentation``;
* ``FlowState.occupied``, ``update_flows`` and ``FLOOD_SCENARIOS``
  against the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import FlowState as JFlowState  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.flowstate import init_state as j_init_state  # noqa: E402
from repro.flowstate import migrate_state as j_migrate_state  # noqa: E402
from repro.flowstate import update_flows as j_update_flows  # noqa: E402
from repro.flowstate import mitigation as jmit  # noqa: E402
from repro.serve.packet_engine import (  # noqa: E402
    PacketServeEngine as JEngine,
)
from repro.serve.sharded import ShardedFlowState as JShardedState  # noqa: E402
from repro.serve.sharded import route_prefix as j_route_prefix  # noqa: E402
from repro.serve.sharded import shard_of_key as j_shard_of_key  # noqa: E402
from repro.telemetry import batch_segmentation as j_segmentation  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import stageir  # noqa: E402
from repro_torch.data import traffic  # noqa: E402
from repro_torch.flowstate import (  # noqa: E402
    MITIGATED,
    FlowState,
    FlowStateSpec,
    StatefulPipeline,
    init_state,
    update_flows,
)
from repro_torch.flowstate.registers import hash_slot_np  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PacketServeEngine,
    ShardedFlowState,
    ShardedPacketServeEngine,
)
from repro_torch.serve import packet_engine  # noqa: E402
from repro_torch.serve.sharded import route_prefix, shard_of_key  # noqa: E402
from repro_torch.testing import mat_stages, two_table_stages  # noqa: E402

SHARDS = (1, 2, 4)


def _flow_stages(n_slots=32, key_cols=(0,)):
    """The reference test's flow pipeline (tests/test_sharded_engine.py)
    as reference stages."""
    spec = JSpec(n_slots=n_slots, n_counters=1, n_ewma=1, hist_sizes=(3,),
                 ewma_alpha=0.5)
    return [jstageir.FlowKey(tuple(key_cols), spec.n_slots),
            jstageir.RegisterUpdate(spec, ewma_cols=(1,), hist_cols=(1,),
                                    hist_edges=(np.linspace(0, 1, 4)[1:-1],)),
            jstageir.WindowStats(spec, mode="all")]


def _mat_stages(mit_slots=32, n_slots=64, mode="drop"):
    """The mitigate-fused pipeline: flow-ddos prefix, the MAT, Mitigate."""
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=n_slots)
    return [fk, ru, ws] + mat_stages(ws.n_out, stageir=jstageir) + [
        jstageir.Mitigate(jmit.MitigationSpec(
            n_slots=mit_slots, mode=mode, threshold=6, keep_every=4))]


def _port(jstages, fuse=True, backend="cuda"):
    return StatefulPipeline(convert.stages_from_reference(jstages),
                            backend=backend, fuse=fuse, device="cpu")


def _sharded(pipe, n, max_batch=16, **kw):
    return ShardedPacketServeEngine(pipe, feature_dim=kw.pop("F", 2),
                                    max_batch=max_batch,
                                    devices=["cpu"] * n, min_shards=1, **kw)


def _metric(eng, name):
    """The value of an unlabelled metric, None when it was never made."""
    snap = eng.telemetry().metrics.snapshot().get(name)
    return None if snap is None else snap["values"][0]["value"]


def _flow_packets(rng, n, n_flows=40):
    X = np.zeros((n, 2), np.float32)
    X[:, 0] = rng.integers(0, n_flows, n)
    X[:, 1] = rng.random(n)
    return X


def _shard_ids(jstages, X, n):
    return j_shard_of_key(jstages[0].apply_keys_np(X), n)


def _per_shard_reference(jstages, X, n, max_batch):
    """The oracle: shard s's rows in arrival order through a JAX engine of
    its own -> (verdicts at arrival positions, the engines)."""
    ids = _shard_ids(jstages, X, n)
    out, engines = None, []
    for s in range(n):
        e = JEngine(JPipeline(jstages), feature_dim=X.shape[1],
                    max_batch=max_batch, telemetry=False)
        e.submit(X[ids == s])
        v = np.asarray(e.flush())
        if out is None:
            out = np.zeros((len(X),) + v.shape[1:], v.dtype)
        out[ids == s] = v
        engines.append(e)
    return out, engines


def _assert_tables_equal(state, engines):
    assert isinstance(state, ShardedFlowState)
    assert state.n_shards == len(engines)
    for t, e in zip(state.tables, engines):
        keys, regs = convert.state_to_numpy(t)
        np.testing.assert_array_equal(keys, np.asarray(e.state.keys))
        np.testing.assert_array_equal(
            regs.view(np.int32), np.asarray(e.state.regs).view(np.int32))
        if getattr(e.state, "mit_spec", None) is not None:
            mk, mr = convert.mitigation_to_numpy(t)
            np.testing.assert_array_equal(mk, np.asarray(e.state.mit_keys))
            np.testing.assert_array_equal(mr, np.asarray(e.state.mit_regs))


# -------------------------------------------------------- routing helpers


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_of_key_and_route_prefix_are_the_references(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 31, 4000).astype(np.int32)
    ids = shard_of_key(keys, n)
    np.testing.assert_array_equal(ids, j_shard_of_key(keys, n))
    assert ids.dtype == np.int64 and ids.min() >= 0 and ids.max() < n
    fk = jstageir.FlowKey((0, 2), 64)
    X = rng.integers(0, 70000, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        convert.stages_from_reference([fk])[0].apply_keys_np(X),
        fk.apply_keys_np(X))
    for cap in (1, 3, 64, 4000):
        m, perm = route_prefix(ids, n, cap)
        jm, jperm = j_route_prefix(ids, n, cap)
        assert m == jm and len(perm) == len(jperm) == n
        for a, b in zip(perm, jperm):
            np.testing.assert_array_equal(a, b)
    m, perm = route_prefix(np.array([0, 1, 0, 0, 1, 0]), 2, capacity=2)
    assert m == 3 and list(perm[0]) == [0, 2] and list(perm[1]) == [1]


# ------------------------------------------------------ stateful parity


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("backend", ["cuda", "interpret"])
def test_stateful_shards_equal_their_single_device_engines(n, backend):
    """The features-only flow pipeline (K2 on the card, its readout
    plain: K1 takes a classifier suffix)."""
    X = _flow_packets(np.random.default_rng(1), 300)
    jstages = _flow_stages()
    eng = _sharded(_port(jstages, False, backend), n, depth=2)
    assert eng.sharded and eng.n_shards == n and eng._sub_batch == 16 // n
    assert eng.stats()["shards"] == n
    eng.submit(X)
    got = eng.flush()
    want, engines = _per_shard_reference(jstages, X, n, 16 // n)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    _assert_tables_equal(eng.state, engines)
    assert eng.state.occupied == sum(e.state.occupied for e in engines)
    # the stacked views read as the reference's [D, S] arrays
    assert tuple(eng.state.keys.shape) == (n, 32)
    assert tuple(eng.state.regs.shape) == (n, 32, eng.state.spec.width)
    assert eng.state.mit_keys is None and eng.state.mitigated_flows == 0
    # the reference's state vocabulary: per-shard arrays round-trip
    arrays = eng.state.arrays()
    assert len(arrays) == n and all(len(a) == 2 for a in arrays)
    again = eng.state.with_arrays(arrays)
    assert all(a.keys is k and a.regs is r
               for a, (k, r) in zip(again.tables, arrays))
    st = eng.stats()
    assert st["packets"] == 300 and st["backend"] == (
        "mixed" if backend == "cuda" else "interpret")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode,fuse", [("drop", True), ("rate_limit", True),
                                       ("drop", False)])
def test_mitigated_shards_equal_their_single_device_engines(n, mode, fuse):
    """The mitigate-fused pipeline, fused (K1) and split (K2 + K4, the
    action table plain)."""
    jstages = _mat_stages(mode=mode)
    stream = jtraffic.make_stream("ddos_burst", n_packets=1500, seed=1)
    X = stream.packets
    eng = _sharded(_port(jstages, fuse), n, max_batch=256, F=4, depth=2)
    assert eng.backend == ("cpu-ref-fused-flow" if fuse else "mixed")
    got = np.concatenate(list(eng.serve_stream(
        X[i:i + 300] for i in range(0, len(X), 300))))
    want, engines = _per_shard_reference(jstages, X, n, 256 // n)
    np.testing.assert_array_equal(got, want)
    assert (got == MITIGATED).sum() > 0
    _assert_tables_equal(eng.state, engines)
    assert eng.state.mitigated_flows == sum(
        e.state.mitigated_flows for e in engines) > 0
    assert tuple(eng.state.mit_keys.shape) == (n, 32)
    arrays = eng.state.arrays()
    assert all(len(a) == 4 for a in arrays)
    again = eng.state.with_arrays(arrays)
    assert all(a.mit_regs is r[3] for a, r in zip(again.tables, arrays))
    assert again.mitigated_flows == eng.state.mitigated_flows
    assert eng.stats()["mitigated"] == int((got == MITIGATED).sum())
    assert _metric(eng, "flow_mit_marked") == eng.state.mitigated_flows
    assert _metric(eng, "flow_occupied_slots") == eng.state.occupied


# ------------------------------------------------------ stateless parity


@pytest.fixture(scope="module")
def ad_case():
    from repro.core import chaining as jchaining
    from repro.core.alchemy import Model as JModel
    from repro.data import netdata

    from repro_torch.testing import AD_WIDTHS, he_mlp

    svm_w, svm_b = he_mlp((7, 2), 1)
    jp = {"ad": [jstageir.FusedMLP(*he_mlp(AD_WIDTHS, 0)),
                 jstageir.Reduce("argmax")],
          "tc": [jstageir.Dense(svm_w[0], svm_b[0]),
                 jstageir.Reduce("argmax")]}

    class _P:                            # a minimal reference pipeline
        def __init__(self, s):
            self.stages = s

    jp = {k: _P(v) for k, v in jp.items()}
    m = {k: JModel({"name": k, "data_loader": lambda: None,
                    "algorithm": None}) for k in jp}
    jnode = m["ad"] > m["tc"]
    X = netdata.make_ad_dataset(features=7, n_train=256,
                                n_test=777).test_x.astype(np.float32)
    return {"jp": jp, "jnode": jnode, "X": X,
            "jprog": jchaining.compile_dag(jnode, jp, backend="pallas"),
            "tp": convert.pipelines_from_reference(jp, device="cpu"),
            "tnode": convert.dag_from_reference(jnode)}


@pytest.mark.parametrize("n", SHARDS)
def test_stateless_shards_equal_the_reference_engine(ad_case, n):
    from repro_torch.core import chaining
    from repro_torch.testing import leaf_margin_rows

    X = ad_case["X"]
    jeng = JEngine(ad_case["jprog"], feature_dim=7, max_batch=64,
                   telemetry=False)
    jeng.submit(X)
    jv = np.asarray(jeng.flush())
    prog = chaining.compile_dag(ad_case["tnode"], ad_case["tp"],
                                backend="cuda", device="cpu")
    eng = ShardedPacketServeEngine(prog, feature_dim=7, max_batch=63,
                                   devices=["cpu"] * n, min_shards=1,
                                   depth=3)
    assert eng.max_batch == -(-63 // n) * n
    got = np.concatenate(list(eng.serve_stream(
        X[i:i + 97] for i in range(0, len(X), 97))))
    close = leaf_margin_rows([ad_case["tp"]["ad"], ad_case["tp"]["tc"]], X)
    assert got.shape == jv.shape == (777,)
    assert int(((got != jv) & ~close).sum()) == 0
    np.testing.assert_array_equal(got, prog(X))
    st = eng.stats()
    assert st["shards"] == n and st["backend"] == "cpu-ref-fused-dag"
    assert st["packets"] == 777


# ------------------------------------------- overflow push-back, edges


def test_dispatch_routed_pushes_overflow_back():
    """30 rows at max_batch 16: the capacity prefix goes out, the rest
    is requeued at the head, and a flush serves them in arrival order."""
    X = _flow_packets(np.random.default_rng(2), 30)
    jstages = _flow_stages()
    eng = _sharded(_port(jstages, False), 1)
    assert eng.sharded and eng._sub_batch == 16
    assert eng._dispatch_routed(X) == 16
    assert eng.pending == 14
    out = eng.flush()
    assert len(out) == 30
    jeng = JEngine(JPipeline(jstages), feature_dim=2, max_batch=16)
    jeng.submit(X)
    np.testing.assert_array_equal(out, np.asarray(jeng.flush()))
    assert _metric(eng, "serve_route_overflow_total") == 14


def test_skewed_keys_overflow_counts_the_requeued_rows():
    """n = 2, most packets on shard 0: each dispatch takes 8 of them and
    pushes the rest back; the counter equals the host replay's push-backs
    and verdicts and tables still equal the per-shard engines'."""
    jstages = _flow_stages()
    ids = _shard_ids(jstages, np.stack([np.arange(400.0), np.zeros(400)],
                                       1).astype(np.float32), 2)
    rng = np.random.default_rng(4)
    X = np.zeros((45, 2), np.float32)
    X[:, 0] = rng.choice(np.flatnonzero(ids == 0)[:5], 45)
    X[:, 1] = rng.random(45)
    X[::9, 0] = np.flatnonzero(ids == 1)[0]      # a few rows for shard 1
    eng = _sharded(_port(jstages, False), 2, depth=2)
    eng.submit(X)
    got = eng.flush()
    # replay the routing on the host: each batch takes up to 16 rows
    ids, pushed, pos = _shard_ids(jstages, X, 2), 0, 0
    while pos < len(X):
        take = ids[pos:pos + 16]
        m, _ = route_prefix(take, 2, 8)
        pushed += len(take) - m
        pos += m
    assert pushed > 0
    assert _metric(eng, "serve_route_overflow_total") == pushed
    want, engines = _per_shard_reference(jstages, X, 2, 8)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    _assert_tables_equal(eng.state, engines)


@pytest.mark.parametrize("n", [1, 2])
def test_ragged_tail_empty_flush_and_empty_stream(n):
    jstages = _flow_stages()
    eng = _sharded(_port(jstages, False), n)
    out = eng.flush()
    assert out.shape == (0,) and eng.pending == 0 and eng.in_flight == 0
    X = _flow_packets(np.random.default_rng(3), 37)     # 37 % 16 != 0
    got = list(eng.serve_stream(iter([X[:5], X[5:20], X[20:]])))
    assert sum(len(g) for g in got) == 37
    want, _ = _per_shard_reference(jstages, X, n, 16 // n)
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert eng.pending == 0 and eng.in_flight == 0
    assert len(eng.flush()) == 0
    fresh = _sharded(_port(jstages, False), n)
    assert list(fresh.serve_stream(iter([]))) == []


# ---------------------------------------------------------- degrading


def test_degrades_where_the_reference_does():
    jstages = _flow_stages()
    X = _flow_packets(np.random.default_rng(5), 50)
    base = PacketServeEngine(_port(jstages, False), feature_dim=2,
                             max_batch=16, device="cpu")
    base.submit(X)
    want = base.flush()
    # fewer devices than min_shards
    eng = ShardedPacketServeEngine(_port(jstages, False), feature_dim=2,
                                   max_batch=16, devices=["cpu"])
    assert not eng.sharded and eng.stats()["shards"] == 1
    eng.submit(X)
    np.testing.assert_array_equal(eng.flush(), want)
    assert _metric(eng, "serve_shards") is None
    # a bare callable
    eng = ShardedPacketServeEngine(lambda x: x[:, 0].to(torch.int32),
                                   feature_dim=2, max_batch=8,
                                   devices=["cpu"] * 2, min_shards=1)
    assert not eng.sharded and eng.stats()["shards"] == 1
    eng.submit(X)
    np.testing.assert_array_equal(eng.flush(), X[:, 0].astype(np.int32))
    # a multi-table pipeline
    two = StatefulPipeline(two_table_stages(stageir, traffic, FlowStateSpec,
                                            n_slots=64, port_slots=64),
                           backend="cuda", device="cpu")
    eng = ShardedPacketServeEngine(two, feature_dim=4, max_batch=32,
                                   devices=["cpu"] * 2, min_shards=1)
    assert not eng.sharded and eng.stats()["shards"] == 1
    # sharded: the stats and the gauge say n
    eng = _sharded(_port(jstages, False), 4)
    assert eng.stats()["shards"] == 4
    assert _metric(eng, "serve_shards") == 4
    with pytest.raises(ValueError, match="one per shard"):
        _sharded(_port(jstages, False), 2,
                 state=_port(jstages, False).init_state())


# ------------------------------------------------------------ hot swap


def test_swap_refusals_leave_the_engine_serving(ad_case):
    from repro_torch.core import chaining

    prog = chaining.compile_dag(ad_case["tnode"], ad_case["tp"],
                                backend="cuda", device="cpu")
    eng = ShardedPacketServeEngine(prog, feature_dim=7, max_batch=64,
                                   devices=["cpu"] * 2, min_shards=1)
    with pytest.raises(ValueError, match="untraceable"):
        eng.swap(lambda x: x[:, 0].astype(np.int32))
    eng.submit(ad_case["X"][:100])
    assert len(eng.flush()) == 100 and eng.stats()["swaps"] == 0

    eng = _sharded(_port(_flow_stages(), False), 2)
    with pytest.raises(ValueError, match="key_cols"):
        eng.swap(_port(_flow_stages(key_cols=(1,)), False))
    two = StatefulPipeline(two_table_stages(stageir, traffic, FlowStateSpec,
                                            n_slots=64, port_slots=64),
                           backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="multi-table"):
        eng.swap(two)
    X = _flow_packets(np.random.default_rng(6), 20)
    eng.submit(X)
    assert len(eng.flush()) == 20 and eng.stats()["swaps"] == 0
    assert not eng.swap_pending


@pytest.mark.parametrize("n", [2, 4])
def test_spec_changing_swap_migrates_each_shard_as_the_reference(n):
    """A swap to twice the slots (and a larger action table): each shard's
    tables equal the reference's ``migrate_state`` / ``migrate_mitigation``
    of its pre-swap tables; no verdict is dropped."""
    old = _mat_stages(mit_slots=32, n_slots=64)
    new = _mat_stages(mit_slots=64, n_slots=128)
    X = jtraffic.make_stream("ddos_burst", n_packets=1200, seed=2).packets
    eng = _sharded(_port(old), n, max_batch=128, F=4, depth=2)
    eng.submit(X[:600])
    first = eng.flush()
    before = [(convert.state_to_numpy(t), convert.mitigation_to_numpy(t))
              for t in eng.state.tables]
    eng.swap(_port(new))
    assert eng.swap_pending
    eng.flush()                              # the boundary installs it
    assert eng.stats()["swaps"] == 1 and not eng.swap_pending
    jspec, jmspec = new[1].spec, new[-1].spec
    for t, ((k, r), (mk, mr)) in zip(eng.state.tables, before):
        want = j_migrate_state(JFlowState(old[1].spec, jnp.asarray(k),
                                          jnp.asarray(r)), jspec)
        keys, regs = convert.state_to_numpy(t)
        np.testing.assert_array_equal(keys, np.asarray(want.keys))
        np.testing.assert_array_equal(regs, np.asarray(want.regs))
        wk, wr = jmit.migrate_mitigation(jnp.asarray(mk), jnp.asarray(mr),
                                         old[-1].spec, jmspec)
        gk, gr = convert.mitigation_to_numpy(t)
        np.testing.assert_array_equal(gk, np.asarray(wk))
        np.testing.assert_array_equal(gr, np.asarray(wr))
        assert t.spec.n_slots == 128 and t.mit_spec.n_slots == 64
    eng.submit(X[600:])
    rest = eng.flush()
    assert len(first) + len(rest) == 1200
    assert eng.stats()["packets"] == 1200


def test_same_spec_swap_carries_the_tables_bit_for_bit():
    jstages = _flow_stages()
    X = _flow_packets(np.random.default_rng(7), 200)
    eng = _sharded(_port(jstages, False), 2)
    eng.submit(X[:100])
    eng.flush()
    tables = [(t.keys, t.regs) for t in eng.state.tables]
    eng.swap(_port(jstages, fuse=False, backend="interpret"))
    eng.flush()                              # the boundary installs it
    assert eng.stats()["swaps"] == 1 and eng.backend == "interpret"
    assert all(t.keys is k and t.regs is r
               for t, (k, r) in zip(eng.state.tables, tables))
    eng.submit(X[100:])
    eng.flush()
    want, engines = _per_shard_reference(jstages, X, 2, 8)
    _assert_tables_equal(eng.state, engines)


# ------------------------------------------------ carry and telemetry


def test_convert_carries_a_reference_sharded_state():
    """A reference ``ShardedFlowState`` (stacked per-shard tables, the
    action tables too) resumes a port engine through ``state=``: the
    second half then equals the per-shard JAX engines continuing."""
    n = 2
    jstages = _mat_stages()
    X = jtraffic.make_stream("ddos_burst", n_packets=1000, seed=3).packets
    ids = _shard_ids(jstages, X, n)
    half = 500
    engines = [JEngine(JPipeline(jstages), feature_dim=4, max_batch=64,
                       telemetry=False) for _ in range(n)]
    want = np.zeros(len(X), np.int32)
    for s, e in enumerate(engines):
        e.submit(X[:half][ids[:half] == s])
        e.flush()
    st = [e.state for e in engines]
    jstate = JShardedState(
        st[0].spec, np.stack([np.asarray(x.keys) for x in st]),
        np.stack([np.asarray(x.regs) for x in st]), st[0].mit_spec,
        np.stack([np.asarray(x.mit_keys) for x in st]),
        np.stack([np.asarray(x.mit_regs) for x in st]))
    state = convert.sharded_state_from_reference(jstate,
                                                 devices=["cpu"] * n)
    assert state.occupied == jstate.occupied
    assert state.mitigated_flows == jstate.mitigated_flows
    eng = _sharded(_port(jstages), n, max_batch=128, F=4, state=state)
    eng.submit(X[half:])
    got = eng.flush()
    for s, e in enumerate(engines):
        rows = ids[half:] == s
        e.submit(X[half:][rows])
        want[half:][rows] = np.asarray(e.flush())
    np.testing.assert_array_equal(got, want[half:])
    _assert_tables_equal(eng.state, engines)
    with pytest.raises(ValueError, match="shards"):
        convert.sharded_state_from_reference(jstate, devices=["cpu"])


def test_segmentation_folds_the_shard_into_the_slot(monkeypatch):
    """Sampled batches segment on ``shard * n_slots + hash_slot``, so
    same-slot chains on different shards never merge; the statistics
    equal the reference's ``batch_segmentation`` on the same slots."""
    seen = []
    real = packet_engine.T.batch_segmentation

    def record(slots, **kw):
        seen.append(np.array(slots))
        return real(slots, **kw)

    monkeypatch.setattr(packet_engine.T, "batch_segmentation", record)
    jstages = _flow_stages(n_slots=4)
    X = _flow_packets(np.random.default_rng(8), 64, n_flows=12)
    eng = _sharded(_port(_flow_stages(n_slots=4), False), 2)
    eng.TELEMETRY_SEG_SAMPLE = 1
    eng.submit(X)
    eng.flush()
    assert seen
    keys = jstages[0].apply_keys_np(X)
    ids = j_shard_of_key(keys, 2)
    pos = 0
    for slots in seen:
        take = ids[pos:pos + 16]
        m, _ = route_prefix(take, 2, 8)
        k = keys[pos:pos + m]
        np.testing.assert_array_equal(
            slots, ids[pos:pos + m] * 4 + hash_slot_np(k, 4))
        assert real(slots) == j_segmentation(slots)
        pos += m
    assert pos == len(X)
    # with eight slots over two shards, chains split by shard
    assert max(len(np.unique(s)) for s in seen) > 4
    assert _metric(eng, "flow_batch_max_chain") == j_segmentation(
        seen[-1])["max_chain"]


# --------------------------------------- flow-state and traffic names


def test_flowstate_occupied_and_update_flows_are_the_references():
    spec = FlowStateSpec(n_slots=16, n_counters=2, n_ewma=1,
                         hist_sizes=(3, 2), ewma_alpha=0.25)
    jspec = JSpec(n_slots=16, n_counters=2, n_ewma=1, hist_sizes=(3, 2),
                  ewma_alpha=0.25)
    rng = np.random.default_rng(9)
    B = 40
    pk = rng.integers(0, 30, B).astype(np.int32)
    upd = rng.random((B, 3)).astype(np.float32)
    bins = np.stack([rng.integers(3, 6, B), rng.integers(6, 8, B)], 1)
    bins[::5] = -1
    valid = (rng.random(B) > 0.2).astype(np.int32)
    jstate = j_init_state(jspec)
    state = init_state(spec, "cpu")
    assert state.occupied == jstate.occupied == 0
    for b_, v_ in ((bins, valid), (None, None)):
        jstate, jfeats = j_update_flows(jstate, pk, upd, b_, v_)
        outs = {be: update_flows(state, pk, upd, b_, v_, backend=be)
                for be in ("interpret", "cuda")}
        for new, feats in outs.values():
            assert isinstance(new, FlowState)
            np.testing.assert_array_equal(feats.numpy().view(np.int32),
                                          np.asarray(jfeats).view(np.int32))
            np.testing.assert_array_equal(new.keys.numpy(),
                                          np.asarray(jstate.keys))
            np.testing.assert_array_equal(
                new.regs.numpy().view(np.int32),
                np.asarray(jstate.regs).view(np.int32))
        state = outs["interpret"][0]
        assert state.occupied == jstate.occupied > 0
    with pytest.raises(KeyError, match="backend"):
        update_flows(state, pk, upd, backend="pallas")


def test_flood_scenarios_are_the_references():
    assert traffic.FLOOD_SCENARIOS == jtraffic.FLOOD_SCENARIOS
    assert set(traffic.FLOOD_SCENARIOS) <= set(traffic.SCENARIOS)
