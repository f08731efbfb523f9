"""Port parity: the mitigation action table, K1's folded mitigation phase
and whole mitigated pipelines.

Ports the reference cases of ``tests/test_mitigation.py``: the arrival-
order oracle, the threshold packet, the rate-limit cadence, no packet
both dropped and verdicted, ``migrate_mitigation``, engines bit-identical
at depth, a swap while flows are rate-limited and a swap that adds or
drops mitigation.  Inputs come from numpy seeds and go through the JAX
function (``mitigate_update``; the fused launch as the Pallas kernel in
interpret mode) and the port's plain versions on CPU tensors.  Action
keys, rows and ``MITIGATED`` positions match bit for bit given the same
classifier verdicts.  A whole mitigated pipeline can only match where
the classifiers agree: the MLP pipeline first checks verdict agreement
under the margin rule and reports its margin rows; the MAT pipeline
(exact scores) is compared bit for bit end to end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pallas_backend as jpb  # noqa: E402
from repro.core import stageir as js  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import mitigation as jmit  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.kernels import fused_flow as jff  # noqa: E402
from repro.serve.packet_engine import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import stageir  # noqa: E402
from repro_torch.data import traffic  # noqa: E402
from repro_torch.flowstate import (  # noqa: E402
    MITIGATED,
    FlowStateSpec,
    MitigatedFlowState,
    MitigationSpec,
    StatefulPipeline,
    init_mitigation,
    migrate_mitigation,
    mitigate_update,
    mitigate_update_segmented,
)
from repro_torch.flowstate.registers import hash_slot_np  # noqa: E402
from repro_torch.kernels import fused_flow as tff  # noqa: E402
from repro_torch.kernels import mat_lut as tml  # noqa: E402
from repro_torch.serve.packet_engine import PacketServeEngine  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    flow_batch,
    mat_stages,
    random_mlp,
    readout_moments,
    verdict_mismatches,
)


def _t(a):
    return torch.as_tensor(np.array(a))


def _oracle(spec, pkt_keys, verdicts, valid):
    """Pure-python arrival-order reference (tests/test_mitigation.py)."""
    keys = np.full(spec.n_slots, -1, np.int64)
    regs = np.zeros((spec.n_slots, 2))
    out = np.array(verdicts, np.int64)
    for p, (k, v, ok) in enumerate(zip(pkt_keys, verdicts, valid)):
        if not ok:
            continue
        s = int(hash_slot_np(np.asarray([k]), spec.n_slots)[0])
        if keys[s] != k:
            keys[s] = k
            regs[s] = 0.0
        hits, since = regs[s]
        marked = hits >= spec.threshold
        drop = marked if spec.mode == "drop" else (
            marked and int(since) % spec.keep_every != 0)
        if drop:
            out[p] = MITIGATED
        regs[s, 0] = hits + (v == spec.attack_class)
        regs[s, 1] = since + 1 if marked else 0.0
    return keys, regs, out


def _update(spec, mk, mr, pkt_keys, verdicts, valid):
    return mitigate_update(_t(mk), _t(mr), _t(pkt_keys), _t(verdicts),
                           _t(valid), spec=spec)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["drop", "rate_limit"])
@pytest.mark.parametrize("n_slots", [2, 4, 16])
def test_mitigate_update_matches_oracle_and_reference(seed, mode, n_slots):
    """Small tables force eviction chains: the port's walk matches the
    python oracle and the JAX scan bit for bit, padding included, over
    two chained batches."""
    rng = np.random.default_rng(seed)
    spec = MitigationSpec(n_slots=n_slots, mode=mode, threshold=3,
                          keep_every=3)
    jspec = jmit.MitigationSpec(n_slots=n_slots, mode=mode, threshold=3,
                                keep_every=3)
    jk, jr = jmit.init_mitigation(jspec)
    tk, tr = init_mitigation(spec, "cpu")
    for _ in range(2):
        n = 96
        pkt_keys = rng.integers(1, 9, n).astype(np.int32)
        verdicts = rng.integers(0, 2, n).astype(np.int32)
        valid = (rng.random(n) < 0.9).astype(np.int32)
        ok_k, ok_r, ok_out = _oracle(spec, pkt_keys, verdicts, valid)
        fresh = tk.numpy().copy()
        jk, jr, jout = jmit.mitigate_update(jk, jr, pkt_keys, verdicts,
                                            valid, spec=jspec)
        tk, tr, tout = mitigate_update(tk, tr, _t(pkt_keys), _t(verdicts),
                                       _t(valid), spec=spec)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                      np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tout.numpy()[valid == 0],
                                      verdicts[valid == 0])
        if (fresh == -1).all():           # first batch: the oracle too
            np.testing.assert_array_equal(tk.numpy(), ok_k)
            np.testing.assert_array_equal(tr.numpy(),
                                          ok_r.astype(np.float32))
            np.testing.assert_array_equal(tout.numpy(), ok_out)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["drop", "rate_limit"])
@pytest.mark.parametrize("n_slots", [2, 16, 256])
def test_segmented_update_matches_walk_and_reference(seed, mode, n_slots):
    """The split path's device form (``mitigate_update_segmented``)
    against the sequential walk and the JAX scan, bit for bit, over
    three chained batches that start from a populated table: stored rows
    marked and unmarked with a nonzero ``since`` (as a threshold change
    leaves them), eviction chains in small tables, bursts of one flow
    broken by others, padding and a non-default attack class."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(n_slots=n_slots, mode=mode, threshold=3, keep_every=3,
              attack_class=2)
    spec = MitigationSpec(**kw)
    jspec = jmit.MitigationSpec(**kw)
    # most flows already hold their slot; a few slots hold strangers
    mk0 = np.where(rng.random(n_slots) < 0.3, rng.integers(20, 40, n_slots),
                   -1).astype(np.int32)
    flows = rng.permutation(np.arange(1, 12, dtype=np.int32))
    mk0[hash_slot_np(flows, n_slots)] = flows
    mr0 = np.stack([rng.integers(0, 6, n_slots),
                    rng.integers(0, 5, n_slots)], 1).astype(np.float32)
    mr0 *= (mk0 >= 0)[:, None]
    jk, jr = mk0, mr0
    wk, wr = sk, sr = _t(mk0), _t(mr0)
    dropped = 0
    for n in (1, 97, 512):
        # flows arrive in bursts of 1-6 packets
        pkt_keys = np.repeat(rng.integers(1, 12, n), rng.integers(1, 7, n)
                             )[:n].astype(np.int32)
        verdicts = rng.integers(0, 3, n).astype(np.int32)
        valid = (rng.random(n) < 0.85).astype(np.int32)
        jk, jr, jout = jmit.mitigate_update(jk, jr, pkt_keys, verdicts,
                                            valid, spec=jspec)
        args = (_t(pkt_keys), _t(verdicts), _t(valid))
        wk, wr, wout = mitigate_update(wk, wr, *args, spec=spec)
        sk, sr, sout = mitigate_update_segmented(sk, sr, *args, spec=spec)
        for seg, walk, ref in ((sk, wk, jk), (sr, wr, jr),
                               (sout, wout, jout)):
            want = np.asarray(ref)
            np.testing.assert_array_equal(walk.numpy(), want)
            np.testing.assert_array_equal(seg.numpy(), want)
            assert seg.dtype == walk.dtype
        dropped += int((sout.numpy() == MITIGATED).sum())
    assert dropped > 0


def test_segmented_update_does_not_write_its_inputs():
    spec = MitigationSpec(n_slots=4, threshold=1)
    mk = _t(np.asarray([3, -1, 7, 9], np.int32))
    mr = _t(np.asarray([[2, 1], [0, 0], [0, 0], [1, 0]], np.float32))
    before = mk.clone(), mr.clone()
    keys = _t(np.asarray([3, 3, 7, 5, 3], np.int32))
    ones = _t(np.ones(5, np.int32))
    k2, r2, out = mitigate_update_segmented(mk, mr, keys, ones, ones,
                                            spec=spec)
    assert torch.equal(mk, before[0]) and torch.equal(mr, before[1])
    wk, wr, wout = mitigate_update(mk, mr, keys, ones, ones, spec=spec)
    assert torch.equal(k2, wk) and torch.equal(r2, wr)
    assert torch.equal(out, wout)
    empty = mitigate_update_segmented(mk, mr, keys[:0], ones[:0], ones[:0],
                                      spec=spec)
    assert torch.equal(empty[0], mk) and empty[2].shape == (0,)


def test_threshold_packet_is_verdicted_not_dropped():
    spec = MitigationSpec(n_slots=64, mode="drop", threshold=3)
    mk, mr = init_mitigation(spec, "cpu")
    _, _, out = _update(spec, mk, mr, np.full(10, 7, np.int32),
                        np.ones(10, np.int32), np.ones(10, np.int32))
    np.testing.assert_array_equal(out.numpy(),
                                  [1, 1, 1, -1, -1, -1, -1, -1, -1, -1])


def test_rate_limit_cadence():
    spec = MitigationSpec(n_slots=64, mode="rate_limit", threshold=2,
                          keep_every=4)
    mk, mr = init_mitigation(spec, "cpu")
    _, _, out = _update(spec, mk, mr, np.full(14, 5, np.int32),
                        np.ones(14, np.int32), np.ones(14, np.int32))
    np.testing.assert_array_equal(
        out.numpy(), [1, 1, 1, -1, -1, -1, 1, -1, -1, -1, 1, -1, -1, -1])


def test_no_packet_both_dropped_and_verdicted():
    rng = np.random.default_rng(0)
    spec = MitigationSpec(n_slots=8, mode="rate_limit", threshold=2,
                          keep_every=2)
    mk, mr = init_mitigation(spec, "cpu")
    _, _, out = _update(spec, mk, mr,
                        rng.integers(1, 30, 256).astype(np.int32),
                        np.ones(256, np.int32), np.ones(256, np.int32))
    out = out.numpy()
    assert set(np.unique(out)) <= {MITIGATED, 1}
    assert (out == MITIGATED).sum() > 0


@pytest.mark.parametrize("new_slots", [32, 4])
def test_migrate_mitigation_matches_reference(new_slots):
    rng = np.random.default_rng(new_slots)
    spec = MitigationSpec(n_slots=8, threshold=2)
    jspec = jmit.MitigationSpec(n_slots=8, threshold=2)
    keys = rng.integers(1, 40, 60).astype(np.int32)
    ones = np.ones(60, np.int32)
    mk, mr = init_mitigation(spec, "cpu")
    mk, mr, _ = mitigate_update(mk, mr, _t(keys), _t(ones), _t(ones),
                                spec=spec)
    new = MitigationSpec(n_slots=new_slots)
    nk, nr = migrate_mitigation(mk, mr, spec, new)
    jk, jr = jmit.migrate_mitigation(mk.numpy(), mr.numpy(), jspec,
                                     jmit.MitigationSpec(n_slots=new_slots))
    np.testing.assert_array_equal(nk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))
    assert nk.shape == (new_slots,) and nr.shape == (new_slots, 2)


def test_spec_validation_and_sentinels():
    with pytest.raises(ValueError, match="power of two"):
        MitigationSpec(n_slots=48)
    with pytest.raises(KeyError, match="mode"):
        MitigationSpec(mode="shape")
    with pytest.raises(ValueError, match="threshold"):
        MitigationSpec(threshold=0)
    with pytest.raises(ValueError, match="keep_every"):
        MitigationSpec(mode="rate_limit", keep_every=1)
    assert traffic._MITIGATED == MITIGATED == jmit.MITIGATED == -1
    mit = stageir.Mitigate(MitigationSpec(n_slots=128))
    jm = js.Mitigate(jmit.MitigationSpec(n_slots=128))
    assert mit.meta() == jm.meta()
    with pytest.raises(TypeError, match="StatefulPipeline"):
        mit.apply(torch.zeros(4, 2))
    (back,) = convert.stages_from_reference([jm])
    assert back.spec == MitigationSpec(n_slots=128)


def test_reaction_report_matches_reference():
    packets = np.zeros((8, 4), np.float32)
    packets[:, traffic.COL_FLOW] = 9
    verdicts = np.asarray([0, 1, 1, 1, -1, -1, 1, -1])
    args = ("synthetic", packets, np.ones(8, np.int32),
            np.full(8, 9, np.int32), {9: 1})
    r = traffic.reaction_report(traffic.PacketStream(*args), verdicts)
    assert r == jtraffic.reaction_report(jtraffic.PacketStream(*args),
                                         verdicts)
    assert r["mitigation_lag_median"] == 3.0 and r["leaked_pkts_total"] == 1
    s = traffic.make_stream("syn_flood", n_packets=3000, seed=2)
    v = np.random.default_rng(0).integers(-1, 2, s.n_packets)
    js_ = jtraffic.make_stream("syn_flood", n_packets=3000, seed=2)
    assert traffic.reaction_report(s, v) == jtraffic.reaction_report(js_, v)


# ------------------------------------- K1's mitigation phase (plain form)

SPEC = FlowStateSpec(n_slots=64, n_counters=2, n_ewma=2,
                     hist_sizes=(16, 8), ewma_alpha=0.125)
W = SPEC.width


@pytest.mark.parametrize("mit_slots", [64, 16, 256])
@pytest.mark.parametrize("mode", ["drop", "rate_limit"])
@pytest.mark.parametrize("pattern", ["slot_runs", "mixed", "one_hot_flow"])
def test_fused_mitigation_matches_pallas(pattern, mode, mit_slots):
    """The fused launch with a MAT suffix and a folded action table —
    the same slot count as the flow table (shared segmentation), fewer
    and more — against the Pallas kernel in interpret mode: both tables,
    the action table and the verdict stream, MITIGATED included."""
    stages = mat_stages(W)
    sfx = ("mat", stages[0].edges, stages[1].tables, stages[3].table, False)
    jsp, jarr = jpb._pack_suffix(sfx, 8, True)
    mat = tml.pack_mat(stages[0].edges, stages[1].tables, stages[3].table)
    jspec = jmit.MitigationSpec(n_slots=mit_slots, mode=mode, threshold=3,
                                keep_every=3)
    plan = MitigationSpec(n_slots=mit_slots, mode=mode, threshold=3,
                          keep_every=3)
    jk, jr = jnp.full((64,), -1, jnp.int32), jnp.zeros((64, W), jnp.float32)
    jmk, jmr = jmit.init_mitigation(jspec)
    tk, tr = _t(np.asarray(jk)), _t(np.asarray(jr))
    tmk, tmr = init_mitigation(plan, "cpu")
    dropped = 0
    for step in range(3):
        b = flow_batch(SPEC, pattern, 128, seed=step + 3, ragged=step == 1,
                       key_slots=max(64, mit_slots))
        jk, jr, jmk, jmr, jv = jff.fused_flow_serve(
            [(jk, jr, b["pkt_keys"], b["upd"], b["bins"])], b["valid"],
            (jff.TablePlan(2, 2, 2, 0.125, W, "all"),), jsp, jarr,
            mitigation=(jmk, jmr, jspec))
        tk, tr, tmk, tmr, tv = tff.fused_flow_serve(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), tff.TablePlan(2, 2, 2, 0.125, W, "all"),
            tff.SuffixPlan("mat", 4), mat, mit=(tmk, tmr, plan))
        for got, want in ((tk, jk), (tr, jr), (tmk, jmk), (tmr, jmr),
                          (tv, jv)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dropped += int((tv.numpy() == MITIGATED).sum())
    if pattern != "mixed" or mode == "drop":
        assert dropped > 0


# ------------------------------------------------ whole pipelines


def _ref_flow_stages(n_slots):
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=n_slots)
    return [fk, ru, ws], ws.n_out


def _ref_mat_pipeline(n_slots, mit_spec):
    base, n_in = _ref_flow_stages(n_slots)
    t = mat_stages(n_in)
    stages = base + [js.Quantize(t[0].edges), js.LUTGather(t[1].tables),
                     js.Reduce("argmax"), js.LabelMap(t[3].table)]
    return stages + ([js.Mitigate(mit_spec)] if mit_spec else [])


def _ref_mlp_pipeline(n_slots, mit_spec):
    """The attack/defense shape: a seeded MLP [28, 16, 8, 2] whose input
    standardisation comes from a syn_flood training stream (seed 0)."""
    base, n_in = _ref_flow_stages(n_slots)
    w, b = random_mlp((n_in, 16, 8, 2), seed=0)
    train = jtraffic.make_stream("syn_flood", n_packets=2000, seed=0)
    mu, sd = readout_moments(convert.stages_from_reference(base),
                             train.packets)
    stages = base + jtraffic.fold_input_standardization(
        [js.FusedMLP(w, b), js.Reduce("argmax")], mu, sd)
    return stages + ([js.Mitigate(mit_spec)] if mit_spec else [])


def _serve(eng, X, chunk):
    return np.concatenate(list(eng.serve_stream(
        X[s:s + chunk] for s in range(0, len(X), chunk))))


@pytest.mark.parametrize("mode", ["drop", "rate_limit"])
@pytest.mark.parametrize("fuse,depth", [(True, 1), (True, 3), (False, 2)])
def test_mat_pipeline_bit_exact_end_to_end(mode, fuse, depth):
    """The mitigate-fused pipeline (MAT suffix + Mitigate) through the
    JAX engine (``backend="pallas"``) and the port's (``backend="cuda"``
    on the CPU): verdict stream, detection table and action table equal
    bit for bit."""
    jspec = jmit.MitigationSpec(n_slots=32, mode=mode, threshold=6,
                                keep_every=4)
    jstages = _ref_mat_pipeline(64, jspec)
    stream = jtraffic.make_stream("ddos_burst", n_packets=1500, seed=1)
    jeng = JEngine(JPipeline(jstages, backend="pallas", fuse=fuse),
                   feature_dim=4, max_batch=256, depth=depth,
                   telemetry=False)
    jv = _serve(jeng, stream.packets, 300)
    pipe = StatefulPipeline(convert.stages_from_reference(jstages),
                            backend="cuda", fuse=fuse, device="cpu")
    assert pipe.n_state_arrays == 4
    assert pipe.backend == ("cpu-ref-fused-flow" if fuse else "mixed")
    eng = PacketServeEngine(pipe, feature_dim=4, max_batch=256, depth=depth,
                            device="cpu")
    tv = _serve(eng, stream.packets, 300)
    np.testing.assert_array_equal(tv, jv)
    assert isinstance(eng.state, MitigatedFlowState)
    mk, mr = convert.mitigation_to_numpy(eng.state)
    np.testing.assert_array_equal(mk, np.asarray(jeng.state.mit_keys))
    np.testing.assert_array_equal(mr, np.asarray(jeng.state.mit_regs))
    keys, regs = convert.state_to_numpy(eng.state)
    np.testing.assert_array_equal(regs.view(np.int32),
                                  np.asarray(jeng.state.regs).view(np.int32))
    assert (tv == MITIGATED).sum() > 0
    assert eng.stats()["mitigated"] == int((tv == MITIGATED).sum())
    assert eng.state.mitigated_flows == jeng.state.mitigated_flows > 0


def test_mlp_pipeline_verdicts_agree_then_tables_match():
    """The attack/defense shape (MLP + Mitigate): first the classifier
    verdicts of the unmitigated pipeline agree under the margin rule
    (margin rows reported), then — with that agreement — the mitigated
    verdicts and both tables equal the JAX engine's."""
    stream = jtraffic.make_stream("syn_flood", n_packets=2000, seed=1)
    plain = convert.stages_from_reference(_ref_mlp_pipeline(64, None))
    pipe = StatefulPipeline(plain, backend="interpret", device="cpu")
    _, tv = pipe(pipe.init_state(), stream.packets)
    from repro_torch.testing import plain_stream

    _, _, logits = plain_stream(plain, stream.packets, 2000, "cpu")
    bad, close = verdict_mismatches(tv, logits)
    print(f"{close} rows within the margin")
    assert bad == 0 and close == 0
    jspec = jmit.MitigationSpec(n_slots=128, threshold=8)
    jstages = _ref_mlp_pipeline(64, jspec)
    jeng = JEngine(JPipeline(jstages, backend="pallas"), feature_dim=4,
                   max_batch=512, telemetry=False)
    jv = _serve(jeng, stream.packets, 512)
    teng = PacketServeEngine(
        StatefulPipeline(convert.stages_from_reference(jstages),
                         backend="cuda", device="cpu"),
        feature_dim=4, max_batch=512, device="cpu")
    mv = _serve(teng, stream.packets, 512)
    np.testing.assert_array_equal(mv, jv)
    assert (mv == MITIGATED).sum() > 0
    np.testing.assert_array_equal(teng.state.mit_keys.numpy(),
                                  np.asarray(jeng.state.mit_keys))
    np.testing.assert_array_equal(teng.state.mit_regs.numpy(),
                                  np.asarray(jeng.state.mit_regs))


def test_backend_names_follow_the_reference():
    jspec = jmit.MitigationSpec(n_slots=64, threshold=3)
    for build in (_ref_mat_pipeline, _ref_mlp_pipeline):
        for mit in (jspec, None):
            stages = convert.stages_from_reference(build(64, mit))
            names = {(b, f): StatefulPipeline(stages, backend=b, fuse=f,
                                              device="cpu").backend
                     for b in ("cuda", "interpret") for f in (True, False)}
            split = "mixed" if mit else "cpu-ref"
            assert names == {("cuda", True): "cpu-ref-fused-flow",
                             ("cuda", False): split,
                             ("interpret", True): "interpret",
                             ("interpret", False): "interpret"}
            jsplit = JPipeline(build(64, mit), backend="pallas",
                               fuse=False).backend
            assert jsplit == ("mixed" if mit else "pallas")


def test_state_round_trips_through_numpy():
    stages = convert.stages_from_reference(_ref_mat_pipeline(
        64, jmit.MitigationSpec(n_slots=32, threshold=2)))
    pipe = StatefulPipeline(stages, backend="cuda", device="cpu")
    stream = traffic.make_stream("ddos_burst", n_packets=600, seed=3)
    st, _ = pipe(pipe.init_state(), stream.packets)
    mk, mr = convert.mitigation_to_numpy(st)
    keys, regs = convert.state_to_numpy(st)
    back = convert.mitigation_from_numpy(
        convert.state_from_numpy(keys, regs, pipe.spec, device="cpu"),
        mk, mr, pipe.mitigation)
    _, v1 = pipe(st, stream.packets[:200])
    _, v2 = pipe(back, stream.packets[:200])
    np.testing.assert_array_equal(v1, v2)
    with pytest.raises(ValueError, match="MitigatedFlowState"):
        pipe(convert.state_from_numpy(keys, regs, pipe.spec, device="cpu"),
             stream.packets[:10])


# ------------------------------------------------------------ hot swap


def _mit_pipeline(mit_spec, n_slots=64, *, fuse=True):
    stages = convert.stages_from_reference(_ref_mlp_pipeline(n_slots, None))
    # always-attack classifier (oracle friendly): class 1 everywhere
    n_in = stages[2].n_out
    stages = stages[:3] + [stageir.FusedMLP([np.zeros((n_in, 2), np.float32)],
                                            [np.asarray([0.0, 1.0],
                                                        np.float32)]),
                           stageir.Reduce("argmax")]
    if mit_spec is not None:
        stages.append(stageir.Mitigate(mit_spec))
    return StatefulPipeline(stages, backend="cuda", fuse=fuse, device="cpu")


def _packets(rng, n, n_keys):
    X = np.zeros((n, 4), np.float32)
    X[:, 0] = rng.integers(1, 1 + n_keys, n)
    X[:, 1] = rng.random(n) * 1500
    return X


def _serve_flushed(eng, X, batch, swap_at=None, swap_to=None):
    out = []
    for i, s in enumerate(range(0, len(X), batch)):
        if i == swap_at:
            eng.swap(swap_to)
        eng.submit(X[s:s + batch])
        out.append(eng.flush())
    return np.concatenate(out)


@pytest.mark.parametrize("seed,threshold,depth,batch", [
    (0, 1, 1, 32), (1, 2, 3, 64), (2, 4, 2, 32), (3, 3, 1, 64)])
def test_hot_swap_during_mitigation(seed, threshold, depth, batch):
    """Swap while flows are rate-limited: exactly one swap, nothing lost,
    marked flows stay marked, and the verdict stream equals the unswapped
    run's (the action table carried bit-identically)."""
    rng = np.random.default_rng(seed)
    X = _packets(rng, 300, n_keys=4)
    spec = MitigationSpec(n_slots=16, mode="rate_limit",
                          threshold=threshold, keep_every=3)
    eng = PacketServeEngine(_mit_pipeline(spec), feature_dim=4,
                            max_batch=batch, depth=depth, device="cpu")
    swap_at = len(X) // batch // 2
    head = _serve_flushed(eng, X[:swap_at * batch], batch)
    marked_before = eng.state.mitigated_flows
    assert marked_before > 0
    tail = _serve_flushed(eng, X[swap_at * batch:], batch, 0,
                          _mit_pipeline(spec))
    v = np.concatenate([head, tail])
    assert len(v) == len(X) and eng.stats()["swaps"] == 1
    assert set(np.unique(v)) <= {MITIGATED, 1}
    assert eng.state.mitigated_flows >= marked_before
    ref = PacketServeEngine(_mit_pipeline(spec), feature_dim=4,
                            max_batch=batch, depth=depth, device="cpu")
    np.testing.assert_array_equal(v, _serve_flushed(ref, X, batch))


def test_swap_can_drop_and_add_mitigation():
    rng = np.random.default_rng(5)
    X = _packets(rng, 200, n_keys=3)
    spec = MitigationSpec(n_slots=16, threshold=2)
    eng = PacketServeEngine(_mit_pipeline(spec), feature_dim=4,
                            max_batch=50, device="cpu")
    _serve_flushed(eng, X, 50)
    assert eng.state.mitigated_flows > 0
    eng.swap(_mit_pipeline(None))
    eng.submit(X[:50])
    v = eng.flush()
    assert not isinstance(eng.state, MitigatedFlowState)
    assert MITIGATED not in v and eng.backend == "cpu-ref-fused-flow"
    eng.swap(_mit_pipeline(spec, fuse=False))
    eng.submit(X[:50])
    eng.flush()
    assert isinstance(eng.state, MitigatedFlowState)
    assert eng.backend == "mixed" and eng.stats()["swaps"] == 2
    changed = MitigationSpec(n_slots=64, threshold=2)
    before = eng.state
    eng.swap(_mit_pipeline(changed))
    eng.flush()
    nk, nr = migrate_mitigation(before.mit_keys, before.mit_regs, spec,
                                changed)
    np.testing.assert_array_equal(eng.state.mit_keys.numpy(), nk.numpy())
    np.testing.assert_array_equal(eng.state.mit_regs.numpy(), nr.numpy())
