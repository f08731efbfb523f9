"""Port parity: hot swap (``PacketServeEngine.swap``) and the re-key path
``migrate_state``.

Ports the reference cases of ``tests/test_hot_swap.py``: a swap injected
between arbitrary submit/flush calls at depth > 1 never drops or
reorders verdicts and carries the register file bit-identically
(checked against a run that switches pipelines at the same packet, and
against the JAX engine making the same swap); a change of statefulness
is refused; a parked swap installs at a flush without traffic; the stats
round-trip through JSON; a changed spec migrates the live table; and
``migrate_state`` re-keys, carries the shared sections and resolves
collisions last-writer-wins exactly as the JAX package does."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stageir as js  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.flowstate import migrate_state as jmigrate  # noqa: E402
from repro.flowstate.registers import FlowState as JState  # noqa: E402
from repro.serve.packet_engine import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.flowstate import (  # noqa: E402
    FlowState,
    FlowStateSpec,
    StatefulPipeline,
    hash_slot_np,
    init_state,
    migrate_state,
)
from repro_torch.kernels.flow_update import hash_slot  # noqa: E402
from repro_torch.serve.packet_engine import PacketServeEngine  # noqa: E402


def _jspec(n_slots=16, n_counters=1, n_ewma=1, hist=(3,)):
    return JSpec(n_slots=n_slots, n_counters=n_counters, n_ewma=n_ewma,
                 hist_sizes=hist, ewma_alpha=0.5)


def _jflow(spec):
    fk = js.FlowKey((0,), spec.n_slots)
    ru = js.RegisterUpdate(spec, ewma_cols=(1,), hist_cols=(1,),
                           hist_edges=(np.linspace(0, 1, 4)[1:-1],))
    return [fk, ru, js.WindowStats(spec, mode="all")]


def _jclassifier(spec, seed):
    """Flow prefix + a seed-dependent MLP: two seeds share the register
    file and give different verdicts."""
    base = _jflow(spec)
    rng = np.random.default_rng(seed)
    n_in = base[2].n_out
    w1 = rng.normal(size=(n_in, 6)).astype(np.float32)
    w2 = rng.normal(size=(6, 2)).astype(np.float32)
    mlp = js.FusedMLP([w1, w2], [np.zeros(6, np.float32),
                                 np.zeros(2, np.float32)])
    return base + [mlp, js.Reduce("argmax")]


def _pipe(jstages, fuse=True):
    return StatefulPipeline(convert.stages_from_reference(jstages),
                            backend="cuda", fuse=fuse, device="cpu")


def _packets(rng, n):
    X = np.zeros((n, 2), np.float32)
    X[:, 0] = rng.integers(0, 6, n)
    X[:, 1] = rng.random(n)
    return X


SCHEDULES = [  # (seed, n packets, max_batch, depth, ops, swap_at, fuse)
    (0, 60, 7, 2, [(13, True), (20, False), (27, True)], 1, True),
    (1, 120, 19, 4, [(31, False), (31, True), (31, False), (27, True)], 2,
     False),
    (2, 10, 2, 3, [(4, True), (6, False)], 0, True),
    (3, 90, 5, 2, [(1, True), (30, False), (30, False), (29, True)], 3,
     True),
]


@pytest.mark.parametrize("seed,n,max_batch,depth,ops,swap_at,fuse",
                         SCHEDULES)
def test_stateful_swap_preserves_order_and_carries_state(
        seed, n, max_batch, depth, ops, swap_at, fuse):
    """Verdicts split exactly at the recorded boundary between the two
    classifiers; the register file equals one continuous run that
    switches classifiers at that packet, and the JAX engine's under the
    same schedule."""
    spec = _jspec()
    old, new = _jclassifier(spec, 7), _jclassifier(spec, 11)
    X = _packets(np.random.default_rng(seed), n)
    eng = PacketServeEngine(_pipe(old, fuse), feature_dim=2,
                            max_batch=max_batch, depth=depth, device="cpu")
    jeng = JEngine(JPipeline(old, backend="pallas", fuse=fuse),
                   feature_dim=2, max_batch=max_batch, depth=depth,
                   telemetry=False)
    got, jgot, pos = [], [], 0
    for i, (k, flush) in enumerate(ops):
        if i == swap_at:
            eng.swap(_pipe(new, fuse))
            jeng.swap(JPipeline(new, backend="pallas", fuse=fuse))
        eng.submit(X[pos:pos + k])
        jeng.submit(X[pos:pos + k])
        pos += k
        if flush:
            got.append(eng.flush())
            jgot.append(jeng.flush())
    got.append(eng.flush())
    jgot.append(jeng.flush())
    v = np.concatenate([g for g in got if len(g)])
    assert len(v) == pos and eng.stats_.swaps == 1
    off = min(eng.stats_.swap_pkt_offsets[0], pos)
    assert off == min(jeng.stats_.swap_pkt_offsets[0], pos)

    ref_old = _pipe(old)
    state = ref_old.init_state()
    ref = []
    if off:
        state, r = ref_old(state, X[:off])
        ref.append(r)
    if pos - off:
        state, r = _pipe(new)(state, X[off:pos])
        ref.append(r)
    np.testing.assert_array_equal(v, np.concatenate(ref))
    np.testing.assert_array_equal(eng.state.keys.numpy(), state.keys.numpy())
    np.testing.assert_array_equal(eng.state.regs.numpy(), state.regs.numpy())
    np.testing.assert_array_equal(v, np.concatenate(
        [g for g in jgot if len(g)]))
    np.testing.assert_array_equal(eng.state.regs.numpy(),
                                  np.asarray(jeng.state.regs))
    assert sum(eng.stats_.backend_counts.values()) == eng.stats_.batches


def test_swap_rejects_statefulness_change():
    eng = PacketServeEngine(_pipe(_jclassifier(_jspec(), 7)),
                            feature_dim=2, max_batch=8, device="cpu")
    with pytest.raises(ValueError, match="statefulness"):
        eng.swap(lambda x: x[:, 0].to(torch.int32))
    assert not eng.swap_pending


def test_swap_installs_on_flush_without_traffic():
    spec = _jspec()
    eng = PacketServeEngine(_pipe(_jclassifier(spec, 7)), feature_dim=2,
                            max_batch=8, depth=3, device="cpu")
    rng = np.random.default_rng(0)
    eng.submit(_packets(rng, 20))
    eng.flush()
    new = _pipe(_jclassifier(spec, 11))
    eng.swap(new)
    assert eng.swap_pending
    assert len(eng.flush()) == 0
    assert not eng.swap_pending and eng.stats_.swaps == 1
    assert eng.pipeline is new
    X = _packets(rng, 4)
    eng.submit(X)
    before = eng.state
    want = new(FlowState(before.spec, before.keys.clone(),
                         before.regs.clone()), X)[1]
    np.testing.assert_array_equal(eng.flush(), want)


def test_serve_stats_as_dict_json_round_trips_after_swap():
    spec = _jspec()
    eng = PacketServeEngine(_pipe(_jclassifier(spec, 7)), feature_dim=2,
                            max_batch=8, depth=2, device="cpu")
    rng = np.random.default_rng(0)
    eng.submit(_packets(rng, 30))
    eng.flush()
    eng.swap(_pipe(_jclassifier(spec, 11), fuse=False))
    eng.submit(_packets(rng, 30))
    eng.flush()
    d = eng.stats()
    assert json.loads(json.dumps(d)) == d
    assert d["swaps"] == 1 and d["swap_pkt_offsets"] == [30]
    assert len(d["swap_lat_ms"]) == 1 and d["swap_lat_ms"][0] > 0
    assert d["backend_batches"] == {"cpu-ref-fused-flow": 4, "cpu-ref": 4}
    assert d["backend"] == "cpu-ref"


def test_swap_changed_spec_migrates_live_table():
    spec = _jspec(n_slots=16)
    eng = PacketServeEngine(_pipe(_jclassifier(spec, 7)), feature_dim=2,
                            max_batch=8, device="cpu")
    rng = np.random.default_rng(1)
    eng.submit(_packets(rng, 40))
    eng.flush()
    before = eng.state
    spec2 = _jspec(n_slots=64)
    eng.swap(_pipe(_jclassifier(spec2, 7)))
    eng.flush()
    assert eng.state.spec == convert.spec_from_reference(spec2)
    want = jmigrate(JState(spec, jnp.asarray(before.keys.numpy()),
                           jnp.asarray(before.regs.numpy())), spec2)
    np.testing.assert_array_equal(eng.state.keys.numpy(),
                                  np.asarray(want.keys))
    np.testing.assert_array_equal(eng.state.regs.numpy(),
                                  np.asarray(want.regs))
    eng.submit(_packets(rng, 10))
    assert len(eng.flush()) == 10


def test_hash_slot_np_matches_kernel_reference(rng):
    keys = rng.integers(0, 1 << 31, 500).astype(np.int32)
    for n_slots in (16, 64, 1024):
        np.testing.assert_array_equal(
            hash_slot_np(keys, n_slots),
            hash_slot(torch.as_tensor(keys), n_slots).numpy())


def _filled_state(spec, rows):
    st = init_state(spec, "cpu")
    for slot, key, row in rows:
        st.keys[slot] = key
        st.regs[slot] = torch.as_tensor(row)
    return st


@pytest.mark.parametrize("new", [
    dict(n_slots=64, n_counters=2, n_ewma=1, hist_sizes=(2,)),
    dict(n_slots=8, n_counters=1, n_ewma=0, hist_sizes=(5,)),
    dict(n_slots=16, n_counters=1, n_ewma=2, hist_sizes=(3, 2)),
])
def test_migrate_state_matches_reference(new):
    spec = FlowStateSpec(n_slots=16, n_counters=1, n_ewma=1,
                         hist_sizes=(3,), ewma_alpha=0.5)
    rng = np.random.default_rng(4)
    rows = [(s, int(k), rng.random(5).astype(np.float32))
            for s, k in zip((3, 9, 10, 15), rng.integers(1, 999, 4))]
    st = _filled_state(spec, rows)
    new_spec = FlowStateSpec(ewma_alpha=0.5, **new)
    out = migrate_state(st, new_spec)
    jout = jmigrate(JState(_jspec(), jnp.asarray(st.keys.numpy()),
                           jnp.asarray(st.regs.numpy())),
                    JSpec(ewma_alpha=0.5, **new))
    assert out.spec == new_spec
    np.testing.assert_array_equal(out.keys.numpy(), np.asarray(jout.keys))
    np.testing.assert_array_equal(out.regs.numpy(), np.asarray(jout.regs))


def test_migrate_state_rekeys_and_carries_shared_sections():
    spec = FlowStateSpec(n_slots=16, n_counters=1, n_ewma=1,
                         hist_sizes=(3,), ewma_alpha=0.5)
    r3 = np.asarray([5.0, 0.25, 1.0, 2.0, 3.0], np.float32)
    r9 = np.asarray([7.0, 0.75, 4.0, 5.0, 6.0], np.float32)
    st = _filled_state(spec, [(3, 111, r3), (9, 222, r9)])
    spec2 = FlowStateSpec(n_slots=64, n_counters=2, n_ewma=1,
                          hist_sizes=(2,), ewma_alpha=0.5)
    out = migrate_state(st, spec2)
    ok, orr = out.keys.numpy(), out.regs.numpy()
    for key, old_row in ((111, r3), (222, r9)):
        s = int(hash_slot_np(np.array([key]), 64)[0])
        assert ok[s] == key
        assert orr[s, 0] == old_row[0] and orr[s, 1] == 0.0
        assert orr[s, 2] == old_row[1]
        np.testing.assert_array_equal(orr[s, 3:5], old_row[2:4])
    assert (ok >= 0).sum() == 2


def test_migrate_state_collision_is_last_writer_wins():
    spec = FlowStateSpec(n_slots=16, n_counters=1, n_ewma=1,
                         hist_sizes=(3,), ewma_alpha=0.5)
    keys_all = np.arange(1, 200, dtype=np.int32)
    pool = keys_all[hash_slot_np(keys_all, 2) == 0]
    k0 = int(pool[0])
    s0 = int(hash_slot_np(np.array([k0]), 16)[0])
    k1 = next(int(k) for k in pool[1:]
              if int(hash_slot_np(np.array([k]), 16)[0]) != s0)
    s1 = int(hash_slot_np(np.array([k1]), 16)[0])
    st = _filled_state(spec, [(s0, k0, [10.0, 0, 0, 0, 0]),
                              (s1, k1, [20.0, 0, 0, 0, 0])])
    out = migrate_state(st, FlowStateSpec(n_slots=2, n_counters=1, n_ewma=1,
                                          hist_sizes=(3,), ewma_alpha=0.5))
    winner, count = (k0, 10.0) if s0 > s1 else (k1, 20.0)
    assert out.keys.numpy()[0] == winner
    assert out.regs.numpy()[0, 0] == count
    assert (out.keys.numpy() >= 0).sum() == 1
