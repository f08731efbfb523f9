"""Port parity: multi-table stateful pipelines (several ``FlowKey
RegisterUpdate [WindowStats]`` groups feeding one classifier).

The same numpy inputs go through the JAX package (``split_stateful_multi``,
``StatefulPipeline`` on the CPU, its fused Pallas launch in interpret
mode, ``fused_flow_serve`` on multi-table operands, ``adopt_state`` and
the engine's hot swap) and through the port on CPU tensors
(``backend="cuda"`` fused and split taking the plain versions, and
``"interpret"``).  Tables and action tables match bit for bit; MAT and
mitigated verdicts exactly; MLP and centroid verdicts under the margin
rule (rows within ``testing.MARGIN`` counted and excused)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pallas_backend as jpb  # noqa: E402
from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.flowstate import MitigationSpec as JMitSpec  # noqa: E402
from repro.flowstate import StatefulPipeline as JPipeline  # noqa: E402
from repro.kernels import fused_flow as jff  # noqa: E402
from repro.serve import PacketServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import cuda_backend, stageir  # noqa: E402
from repro_torch.data import traffic as ttraffic  # noqa: E402
from repro_torch.flowstate import (  # noqa: E402
    FlowState,
    MultiFlowState,
    StatefulPipeline,
    init_state,
)
from repro_torch.flowstate.registers import FlowStateSpec  # noqa: E402
from repro_torch.kernels import fused_flow as tff  # noqa: E402
from repro_torch.kernels.flow_update import flow_update_ref  # noqa: E402
from repro_torch.kernels.fused_mlp import pack_params  # noqa: E402
from repro_torch.serve.packet_engine import PacketServeEngine  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    flow_batch,
    random_mlp,
    mat_stages,
    two_table_stages,
    verdict_mismatches,
)

N_SLOTS, PORT_SLOTS, B = 64, 16, 128


def _jax_two_table(suffix="mlp", mitigated=False, *, n_slots=N_SLOTS,
                   port_slots=PORT_SLOTS, seed=0):
    """The smoke's two-table configuration at narrow slot counts."""
    mit = (JMitSpec(n_slots=n_slots, threshold=3) if mitigated else None)
    return two_table_stages(jstageir, jtraffic, JSpec, n_slots=n_slots,
                            port_slots=port_slots, suffix=suffix,
                            mitigation=mit, seed=seed)


def _jax_single(suffix="mlp", mit=None):
    """The flow-ddos table alone, with a classifier of its width."""
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    cls = (mat_stages(ws.n_out, stageir=jstageir) if suffix == "mat" else
           [jstageir.FusedMLP(*random_mlp((ws.n_out, 16, 2), seed=3)),
            jstageir.Reduce("argmax")])
    return [fk, ru, ws] + cls + ([jstageir.Mitigate(mit)] if mit else [])


def _jax_test_shape(mitigated=False):
    """``tests/test_fused_flow.py::_two_table_stages``: a second table keyed
    by the flow column itself, no readout stage of its own."""
    rng = np.random.default_rng(0)
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    spec2 = JSpec(n_slots=32, n_counters=2, n_ewma=0, hist_sizes=())
    fk2 = jstageir.FlowKey((0,), spec2.n_slots)
    ru2 = jstageir.RegisterUpdate(spec2, counter_cols=(0,))
    n_in = ws.n_out + spec2.width
    w1 = rng.normal(size=(n_in, 6)).astype(np.float32)
    w2 = rng.normal(size=(6, 2)).astype(np.float32)
    mlp = jstageir.FusedMLP([w1, w2], [np.zeros(6, np.float32),
                                       np.zeros(2, np.float32)])
    stages = [fk, ru, ws, fk2, ru2, mlp, jstageir.Reduce("argmax")]
    if mitigated:
        stages.append(jstageir.Mitigate(JMitSpec(n_slots=32, threshold=3)))
    return stages


def _batches(scenario="ddos_burst", n=600, seed=2, batch=B):
    """A stream in fixed [batch, 4] batches, the tail padded (valid 0)."""
    x = jtraffic.make_stream(scenario, n_packets=n, seed=seed).packets
    out = []
    for s in range(0, len(x), batch):
        rows = x[s:s + batch]
        X = np.zeros((batch, x.shape[1]), np.float32)
        X[:len(rows)] = rows
        valid = np.zeros(batch, np.int32)
        valid[:len(rows)] = 1
        out.append((X, valid))
    return out


def _host_state(state):
    """Every table of a JAX or port state as numpy (floats as int32 bits)."""
    kl = getattr(state, "keys_list", None) or (state.keys,)
    rl = getattr(state, "regs_list", None) or (state.regs,)
    arrs = []
    for k, r in zip(kl, rl):
        arrs += [np.asarray(k), np.asarray(r, np.float32).view(np.int32)]
    if getattr(state, "mit_spec", None) is not None:
        arrs += [np.asarray(state.mit_keys),
                 np.asarray(state.mit_regs, np.float32).view(np.int32)]
    return arrs


def _assert_states_equal(a, b, what):
    ha, hb = _host_state(a), _host_state(b)
    assert len(ha) == len(hb), what
    for i, (x, y) in enumerate(zip(ha, hb)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: array {i}")


def _classifier_scores(tstages, batches):
    """The plain classifier scores of every batch, from a sequential walk
    of the port's tables -> (scores per batch, use_min, label map)."""
    rest, _ = stageir.split_mitigation(tstages)
    groups, suffix = stageir.split_stateful_multi(rest)
    body = stageir.unfuse_pipeline_stages(suffix)
    states = [init_state(ru.spec, "cpu") for _, ru, _ in groups]
    use_min, lmap, head = False, None, body[:-1]
    if isinstance(body[-1], stageir.LabelMap):      # centroid
        use_min = body[-2].op == "argmin"
        lmap, head = np.asarray(body[-1].table), body[:-2]
    out = []
    for X, valid in batches:
        x, v = torch.as_tensor(X), torch.as_tensor(valid)
        zs = []
        for t, (fk, ru, ws) in enumerate(groups):
            sp = ru.spec
            upd, bins = ru.prepare(x)
            k, r, f = flow_update_ref(states[t].keys, states[t].regs,
                                      fk.apply_keys(x), upd, bins, v,
                                      n_counters=sp.n_counters,
                                      n_ewma=sp.n_ewma, alpha=sp.ewma_alpha)
            states[t] = FlowState(sp, k, r)
            zs.append(f if ws is None else ws.apply(f))
        out.append(stageir.apply_stages(head, torch.cat(zs, 1),
                                        plain=True).numpy())
    return out, use_min, lmap


def _serve(pipe, batches):
    state, vs = pipe.init_state(), []
    for X, valid in batches:
        state, v = pipe(state, X, valid)
        vs.append(np.asarray(v)[valid == 1])
    return state, vs


# ------------------------------------------------------------ the grammar


def _grammar_cases():
    (fk, ru, ws), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    two = _jax_two_table()
    fk2, ru2, ws2 = two[3:6]
    cls = two[6:]
    return {
        "single": [fk, ru, ws] + cls,
        "two_readouts": two,
        "second_raw": [fk, ru, ws, fk2, ru2] + cls,
        "first_raw": [fk, ru, fk2, ru2, ws2] + cls,
        "three_tables": [fk, ru, ws, fk2, ru2, ws2, fk2, ru2] + cls,
        "key_without_update": [fk, ru, ws, fk2, ws2] + cls,
        "no_table": [ws] + cls,
        "table_in_suffix": [fk, ru, ws] + cls[:1] + [ru2] + cls[1:],
    }


@pytest.mark.parametrize("case", sorted(_grammar_cases()))
def test_split_stateful_multi_matches_reference(case):
    """The same groups and suffix as the JAX ``split_stateful_multi`` on
    valid pipelines, the same error on malformed ones."""
    jst = _grammar_cases()[case]
    tst = convert.stages_from_reference(jst)
    try:
        jgroups, jsuffix = jstageir.split_stateful_multi(jst)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            stageir.split_stateful_multi(tst)
        assert str(got.value) == str(e)
        return
    tgroups, tsuffix = stageir.split_stateful_multi(tst)
    assert [tuple(None if s is None else s.kind for s in g)
            for g in tgroups] == [tuple(None if s is None else s.kind
                                        for s in g) for g in jgroups]
    assert [s.kind for s in tsuffix] == [s.kind for s in jsuffix]
    for tg, jg in zip(tgroups, jgroups):
        assert tg[0].key_cols == tuple(jg[0].key_cols)
        assert tg[1].spec.width == jg[1].spec.width


def test_apply_keys_np_matches_apply_keys():
    """``FlowKey.apply_keys_np`` (the telemetry's host-side keys) equals
    ``apply_keys`` and the JAX package's ``apply_keys_np``, on integral
    and fractional columns, half-way values and large magnitudes."""
    rng = np.random.default_rng(3)
    X = np.concatenate([
        rng.integers(0, 1 << 22, (200, 4)).astype(np.float32),
        (rng.random((200, 4)) * 3000 - 1000).astype(np.float32),
        np.asarray([[0.5, 1.5, 2.5, -0.5], [1e9, -1e9, 65535.5, 7]],
                   np.float32)])
    for cols in ((0,), (3,), (0, 3), (1, 2, 3)):
        tfk = stageir.FlowKey(cols, 64)
        want = jstageir.FlowKey(cols, 64).apply_keys_np(X)
        np.testing.assert_array_equal(tfk.apply_keys_np(X), want)
        np.testing.assert_array_equal(
            tfk.apply_keys(torch.as_tensor(X)).numpy(), want)


def test_convert_keeps_the_flow_keys_distinct():
    """``stages_from_reference`` carries each group's own FlowKey."""
    tst = convert.stages_from_reference(_jax_two_table())
    groups, _ = stageir.split_stateful_multi(tst)
    assert [g[0].key_cols for g in groups] == [(jtraffic.COL_FLOW,),
                                              (jtraffic.COL_PORT,)]
    assert [g[0].n_slots for g in groups] == [N_SLOTS, PORT_SLOTS]


# -------------------------------------------------- whole pipelines


PIPELINE_CASES = ([("jax_test", "mlp", m) for m in (False, True)]
                  + [("two_table", s, m) for s in ("mlp", "mat", "centroid")
                     for m in (False, True)])


@pytest.mark.parametrize("shape,suffix,mitigated", PIPELINE_CASES)
def test_two_table_pipeline_matches_jax(shape, suffix, mitigated):
    """A whole two-table pipeline over a ragged ddos_burst stream: the
    port fused (K1's multi-table plain version), split (K2's plain version
    per table + the classifier) and interpreted, against the JAX
    ``StatefulPipeline`` on the CPU.  Tables bit for bit; verdicts exact
    for MAT and mitigated pipelines, under the margin rule otherwise."""
    jst = (_jax_test_shape(mitigated) if shape == "jax_test"
           else _jax_two_table(suffix, mitigated))
    tst = convert.stages_from_reference(jst)
    batches = _batches()
    jp = JPipeline(jst)
    assert jp.n_tables == 2
    jstate, jv = _serve(jp, batches)
    scores = None
    if suffix != "mat":
        scores, use_min, lmap = _classifier_scores(tst, batches)
    want_split = "mixed" if mitigated or suffix == "centroid" else "cpu-ref"
    for backend, fuse, name in (("cuda", True, "cpu-ref-fused-flow"),
                                ("cuda", False, want_split),
                                ("interpret", True, "interpret")):
        pipe = StatefulPipeline(tst, backend=backend, fuse=fuse,
                                device="cpu")
        assert pipe.backend == name and pipe.n_tables == 2
        assert "tables=2" in repr(pipe)
        state, tv = _serve(pipe, batches)
        assert isinstance(state, MultiFlowState)
        _assert_states_equal(state, jstate, f"{name} vs JAX")
        for i, (a, b) in enumerate(zip(tv, jv)):
            if scores is None or mitigated:
                np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
            else:
                valid = batches[i][1] == 1
                bad, _ = verdict_mismatches(a, scores[i][valid],
                                            use_min=use_min, label_map=lmap)
                assert bad == 0, f"{name} batch {i}"
    if mitigated and scores is not None:
        # exact given the same verdicts: no row sits within the margin
        for i, sc in enumerate(scores):
            sc = sc[batches[i][1] == 1]
            top = np.sort(-sc if use_min else sc, 1)
            assert np.all(top[:, -1] - top[:, -2] > 1e-4), f"batch {i}"


@pytest.mark.parametrize("suffix,mitigated", [("mlp", False),
                                              ("mat", True)])
def test_two_table_pipeline_matches_pallas_fused(suffix, mitigated):
    """Against the JAX package's fused multi-table launch (Pallas
    ``_serve_kernel``, interpret mode), as ``tests/test_fused_flow.py``
    runs it."""
    jst = _jax_two_table(suffix, mitigated)
    batches = _batches(n=200, batch=64)
    jp = JPipeline(jst, backend="pallas")
    assert jp.backend == "pallas-fused-flow"
    jstate, jv = _serve(jp, batches)
    pipe = StatefulPipeline(convert.stages_from_reference(jst),
                            backend="cuda", device="cpu")
    state, tv = _serve(pipe, batches)
    _assert_states_equal(state, jstate, "fused vs Pallas")
    if suffix == "mat":
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a, b)
    else:
        scores, _, _ = _classifier_scores(pipe.stages, batches)
        for i, (a, sc) in enumerate(zip(tv, scores)):
            bad, _ = verdict_mismatches(a, sc[batches[i][1] == 1])
            assert bad == 0


# -------------------------------------------- the multi-table K1 function


def _k1_operands(kind, n_mit, pattern, seed):
    """Two tables' operands at B=64 for both packages -> (jax args, port
    args, scores-or-None)."""
    specs = [FlowStateSpec(n_slots=64, n_counters=2, n_ewma=2,
                           hist_sizes=(16, 8)),
             FlowStateSpec(n_slots=16, n_counters=2, n_ewma=1,
                           hist_sizes=(16,))]
    modes = ("all", "hist")
    jtps = [jff.TablePlan(s.n_counters, s.n_ewma, len(s.hist_sizes),
                          s.ewma_alpha, s.width, m) for s, m in
            zip(specs, modes)]
    ttps = [tff.TablePlan(*tp) for tp in jtps]
    n_in = sum(tp.n_out for tp in ttps)
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        ws, bs = random_mlp((n_in, 8, 2), seed=seed)
        sfx = ("mlp", ws, bs)
        tparams, tsp = pack_params(ws, bs), tff.SuffixPlan("mlp", 2)
    else:
        cent = rng.random((3, 5)).astype(np.float32)
        fidx = (0, 3, 27, 28, 30)
        lmap = np.asarray([1, 0, 1], np.int32)
        sfx = ("centroid", fidx, cent, lmap, True)
        tparams = tff.pack_centroids(cent, lmap, fidx, use_min=True)
        tsp = tff.SuffixPlan("centroid", 3)
    jsp, jarr = jpb._pack_suffix(sfx, 8, True)
    tables_np = []
    for t, spec in enumerate(specs):
        b = flow_batch(spec, pattern, 64, seed=seed + t, ragged=True)
        tables_np.append(b)
    valid = tables_np[0]["valid"]
    mit = None
    if n_mit:
        mit = (np.full(n_mit, -1, np.int32), np.zeros((n_mit, 2), np.float32))
    return specs, jtps, ttps, (jsp, jarr), (tsp, tparams), tables_np, \
        valid, mit


@pytest.mark.parametrize("kind,n_mit,pattern", [
    ("mlp", 0, "mixed"), ("mlp", 64, "slot_runs"), ("mlp", 32, "same_slot"),
    ("centroid", 0, "one_hot_flow"), ("centroid", 128, "slot_runs")])
def test_plain_multi_k1_matches_jax_fused_flow_serve(kind, n_mit, pattern):
    """``fused_flow_serve_multi`` on CPU tensors (the plain version K1's
    multi-table mode is held to on the card) against the JAX
    ``fused_flow_serve`` on the same multi-table operands (the Pallas
    kernel in interpret mode): two chained batches, the second from the
    tables the first left; tables and action table bit for bit, verdicts
    of valid rows exact here (no margin rows on these seeds)."""
    specs, jtps, ttps, (jsp, jarr), (tsp, tparams), tabs, valid, mit = \
        _k1_operands(kind, n_mit, pattern, seed=40 + n_mit)
    jstate = [(jnp.full((s.n_slots,), -1, jnp.int32),
               jnp.zeros((s.n_slots, s.width), jnp.float32)) for s in specs]
    tstate = [(torch.full((s.n_slots,), -1, dtype=torch.int32),
               torch.zeros((s.n_slots, s.width))) for s in specs]
    mspec = JMitSpec(n_slots=n_mit, threshold=2) if n_mit else None
    tmspec = (tff.MitigationSpec(n_slots=n_mit, threshold=2) if n_mit
              else None)
    jm = tm = None
    if mit is not None:
        jm = (jnp.asarray(mit[0]), jnp.asarray(mit[1]))
        tm = (torch.as_tensor(mit[0]), torch.as_tensor(mit[1]))
    for step in range(2):
        if step:
            tabs = [flow_batch(s, pattern, 64, seed=90 + t, ragged=False)
                    for t, s in enumerate(specs)]
            valid = np.ones(64, np.int32)
        jt = [(k, r, jnp.asarray(b["pkt_keys"]), jnp.asarray(b["upd"]),
               jnp.asarray(b["bins"])) for (k, r), b in zip(jstate, tabs)]
        tt = [(k, r, torch.as_tensor(b["pkt_keys"]),
               torch.as_tensor(b["upd"]), torch.as_tensor(b["bins"]))
              for (k, r), b in zip(tstate, tabs)]
        jres = jff.fused_flow_serve(
            jt, jnp.asarray(valid), jtps, jsp, jarr,
            None if jm is None else (*jm, mspec), interpret=True)
        tres = tff.fused_flow_serve_multi(
            tt, torch.as_tensor(valid), ttps, tsp, tparams,
            None if tm is None else (*tm, tmspec))
        assert len(jres) == len(tres)
        for i, (a, b) in enumerate(zip(jres[:-1], tres[:-1])):
            a = np.asarray(a)
            b = b.numpy()
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"step {step} "
                                          f"output {i}")
        live = valid == 1
        np.testing.assert_array_equal(np.asarray(jres[-1])[live],
                                      tres[-1].numpy()[live])
        jstate = [(jres[2 * t], jres[2 * t + 1]) for t in range(2)]
        tstate = [(tres[2 * t], tres[2 * t + 1]) for t in range(2)]
        if mit is not None:
            jm, tm = (jres[4], jres[5]), (tres[4], tres[5])


def test_multi_table_count_is_bounded_by_the_parameter_space():
    """K1 takes up to ``MAX_TABLES`` tables in one launch (the descriptors
    ride in the kernel parameter space); past that it declines by name and
    ``StatefulPipeline(backend="cuda")`` raises with the reason."""
    tst = convert.stages_from_reference(_jax_two_table())
    fk, ru, ws = tst[:3]
    cls = tst[6:]
    n_in = ws.n_out * 3
    mlp = [stageir.FusedMLP(*random_mlp((n_in, 4, 2), seed=1)),
           stageir.Reduce("argmax")]
    three = [fk, ru, ws] * 3 + mlp
    groups, suffix = stageir.split_stateful_multi(three)
    assert cuda_backend.fused_flow_decline_reason(groups, suffix) is None
    many = [(fk, ru, ws)] * (tff.MAX_TABLES + 1)
    reason = cuda_backend.fused_flow_decline_reason(many, cls)
    assert reason == tff.tables_reason(tff.MAX_TABLES + 1)
    assert f"> {tff.MAX_TABLES}" in reason
    assert tff.tables_reason(tff.MAX_TABLES) is None


# ---------------------------------------------------- adopt_state, swaps


def _adopt_cases():
    single = lambda mit=None: _jax_single(mit=mit)  # noqa: E731
    m16 = JMitSpec(n_slots=16, threshold=3)
    m32 = JMitSpec(n_slots=32, threshold=3)
    wider = _jax_two_table(port_slots=2 * PORT_SLOTS)
    three = _jax_two_table()[:6] + _jax_two_table()[3:6] + [
        jstageir.FusedMLP(*random_mlp((28 + 19 + 19, 4, 2), seed=2)),
        jstageir.Reduce("argmax")]
    two_m = lambda mit: _jax_two_table() + [jstageir.Mitigate(mit)]  # noqa
    return {
        "single_to_multi": (single(), _jax_two_table()),
        "multi_to_single": (_jax_two_table(), single()),
        "same_specs": (_jax_two_table(), _jax_two_table(seed=5)),
        "table_1_rekeyed": (_jax_two_table(), wider),
        "table_count_2_to_3": (_jax_two_table(), three),
        "mit_carried": (two_m(m16), two_m(m16)),
        "mit_rekeyed": (two_m(m16), two_m(m32)),
        "mit_swapped_in": (_jax_two_table(), two_m(m16)),
        "mit_swapped_out": (two_m(m16), _jax_two_table()),
        "single_mit_to_multi_mit": (single(m16), two_m(m16)),
    }


@pytest.mark.parametrize("case", sorted(_adopt_cases()))
def test_adopt_state_matches_jax(case):
    """``adopt_state`` carries, re-keys or restarts each table and the
    action table as the JAX package does, on the same live state."""
    old, new = _adopt_cases()[case]
    jold, jnew = JPipeline(old), JPipeline(new)
    jstate, _ = _serve(jold, _batches(n=300))
    told = StatefulPipeline(convert.stages_from_reference(old),
                            device="cpu")
    tnew = StatefulPipeline(convert.stages_from_reference(new),
                            device="cpu")
    tstate, _ = _serve(told, _batches(n=300))
    _assert_states_equal(tstate, jstate, "before the swap")
    _assert_states_equal(tnew.adopt_state(tstate), jnew.adopt_state(jstate),
                         case)


@pytest.mark.parametrize("fuse", [True, False])
def test_engine_swaps_single_multi_match_jax(fuse):
    """The engine hot-swaps from the single-table flow-ddos pipeline to a
    mitigated two-table one and back, mid-stream: verdicts, swap offsets
    and final state as the JAX engine's (the detection tables start fresh
    at each swap, the action table carries while its spec holds)."""
    m = JMitSpec(n_slots=N_SLOTS, threshold=3)
    two = _jax_two_table("mat", mitigated=True)
    single = _jax_single("mat", m)
    plan = [(0, None), (2, two), (4, single)]
    stream = jtraffic.make_stream("ddos_burst", n_packets=900, seed=4)
    chunks = [stream.packets[i:i + 150] for i in range(0, 900, 150)]

    def run(make_pipe, make_engine):
        eng = make_engine(make_pipe(single))
        out = []
        for i, c in enumerate(chunks):
            for at, stages in plan:
                if at == i and stages is not None:
                    eng.swap(make_pipe(stages))
            eng.submit(c)
            out.append(np.asarray(eng.flush()))
        return np.concatenate(out), eng

    jv, jeng = run(lambda st: JPipeline(st),
                   lambda p: JEngine(p, feature_dim=4, max_batch=64))
    tv, teng = run(lambda st: StatefulPipeline(
        convert.stages_from_reference(st), backend="cuda", fuse=fuse,
        device="cpu"),
        lambda p: PacketServeEngine(p, feature_dim=4, max_batch=64,
                                    device="cpu"))
    assert m.n_slots == N_SLOTS
    np.testing.assert_array_equal(tv, jv)
    assert teng.stats()["swaps"] == jeng.stats()["swaps"] == 2
    assert teng.stats()["swap_pkt_offsets"] \
        == jeng.stats()["swap_pkt_offsets"]
    _assert_states_equal(teng.state, jeng.state, "after the swaps")


# ------------------------------------------------------------- convert


@pytest.mark.parametrize("mitigated", [False, True])
def test_convert_round_trips_multi_flow_state(mitigated):
    """``state_from_numpy``/``state_to_numpy`` (and the action table's
    pair) round-trip a ``MultiFlowState`` bit for bit, and reject a table
    of the wrong shape."""
    jp = JPipeline(_jax_two_table("mat", mitigated))
    jstate, _ = _serve(jp, _batches(n=300))
    specs = tuple(convert.spec_from_reference(s) for s in jstate.specs)
    st = convert.state_from_numpy(
        [np.asarray(k) for k in jstate.keys_list],
        [np.asarray(r) for r in jstate.regs_list], specs, device="cpu")
    assert isinstance(st, MultiFlowState) and st.spec == specs[0]
    if mitigated:
        st = convert.mitigation_from_numpy(
            st, np.asarray(jstate.mit_keys), np.asarray(jstate.mit_regs),
            convert.mitigation_spec_from_reference(jstate.mit_spec))
        assert st.mitigated_flows == jstate.mitigated_flows
        mk, mr = convert.mitigation_to_numpy(st)
        np.testing.assert_array_equal(mk, np.asarray(jstate.mit_keys))
    _assert_states_equal(st, jstate, "round trip")
    assert st.occupied == jstate.occupied
    kl, rl = convert.state_to_numpy(st)
    for a, b in zip(kl + rl, tuple(jstate.keys_list) + tuple(jstate.regs_list)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="do not match"):
        convert.state_from_numpy(kl, rl[::-1], specs, device="cpu")
    # the port's own pipeline serves on from the converted state
    pipe = StatefulPipeline(convert.stages_from_reference(
        _jax_two_table("mat", mitigated)), device="cpu")
    pipe(st, *_batches(n=64)[0])


def test_multi_flow_state_aliases_table_zero():
    """``spec``/``keys``/``regs`` alias table 0; ``occupied`` sums every
    table; a pipeline refuses a state of another table layout."""
    pipe = StatefulPipeline(convert.stages_from_reference(_jax_two_table()),
                            device="cpu")
    st, _ = _serve(pipe, _batches(n=200))
    assert st.keys is st.keys_list[0] and st.regs is st.regs_list[0]
    assert st.spec == pipe.specs[0] and pipe.spec == pipe.specs[0]
    assert st.occupied == sum(int((k >= 0).sum()) for k in st.keys_list)
    assert st.mitigated_flows == 0 and pipe.n_state_arrays == 4
    single = StatefulPipeline(convert.stages_from_reference(_jax_single()),
                              device="cpu")
    with pytest.raises(ValueError, match="MultiFlowState"):
        pipe.dispatch(single.init_state(), _batches(n=64)[0][0])
    assert isinstance(ttraffic.COL_PORT, int)
