"""xLSTM-1.3B (the ssm family: periods of one sLSTM and seven mLSTM
blocks, no attention, no FFN) in the port against the reference, on CPU
tensors: the configs, the layout, the cache tree and the parameter
count; the mLSTM chunkwise (several chunks, a carried state) and single
step, and the sLSTM, each against ``repro.models.xlstm``; the chunk
rule; ``forward`` in f32 in every mode; decode through the recurrent
state against teacher forcing; the ``ServeEngine`` against the
reference's.  Weights come from the reference's init, carried across by
``convert.lm_params_from_reference``; inputs from numpy seeds.

Tolerances, f32: the blocks within 1e-5 of the output's scale (their
states too); ``forward`` within 1e-4 plus 8 times what the reference
differs from itself when only its mLSTM's summation order changes (its
chunkwise form at chunks of 4 against 128), a mode's bound taking the
larger of its own and the train forward's; the engine's tokens equal or
first differing only where the reference's top two logits, along its
own serving path, lie within twice the two packages' logit distance
there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pytree as pt
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.steps import init_cache as jax_init_cache
from repro.train.step import init_train_state
from repro_torch import configs, convert
from repro_torch.models import registry as TR
from repro_torch.models import xlstm as TX
from repro_torch.models.transformer import decoder_layout, forward
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)

ARCH = "xlstm-1.3b"
TOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_abs(a, b) -> float:
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(_np(a) - b.astype(np.float32)).max())


def _close(a, b, what) -> None:
    scale = max(1.0, float(np.abs(_np(a)).max()))
    assert _max_abs(a, b) <= TOL * scale, (what, _max_abs(a, b), scale)


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _params(cfg, seed=0):
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(seed))["params"],
        jnp.float32)
    return params, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _cache_to_torch(cache) -> dict:
    return {s: {k: {n: _t(np.asarray(a)) for n, a in d.items()}
                for k, d in v.items()} for s, v in cache.items()}


def _state(tree: dict) -> dict:
    return {k: _t(np.asarray(v)) for k, v in tree.items()}


# ------------------------------------------------- configs and layout


def test_configs_layout_and_param_count_are_the_references():
    for ours, ref in ((configs.get_config(ARCH), jax_get_config(ARCH)),
                      (configs.get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert TR.param_count(ours) == JR.param_count(ref)
        n_p, slots = decoder_layout(ours)
        assert n_p == ours.num_layers // 8 == JT.decoder_layout(ref)[0]
        assert [(s.mixer, s.ffn, s.cross) for s in slots] == [
            (s.mixer, s.ffn, s.cross) for s in JT.decoder_layout(ref)[1]] \
            == [("slstm", "none", False)] + [("mlstm", "none", False)] * 7
    full = configs.get_config(ARCH)
    # 2.5 GB of bf16 weights
    assert 1.23e9 < TR.param_count(full) < 1.25e9


def test_registry_and_init_follow_the_reference():
    cfg = configs.get_smoke_config(ARCH)
    tc = TR.cache_defs(cfg, 3, 20)
    jc = JR.cache_defs(jax_smoke(ARCH), 3, 20)
    assert {s: {k: {n: d.shape for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in tc.items()} \
        == {s: {k: {n: tuple(d.shape) for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in jc.items()}
    assert tc["slot1"]["mlstm"]["conv"].dtype == torch.bfloat16
    assert tc["slot0"]["slstm"]["m"].dtype == torch.float32
    params = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    jdefs = JR.param_defs(jax_smoke(ARCH))["decoder"]
    assert set(params["layers"][0]) == set(jdefs["slot0"]) == {"ln1",
                                                              "slstm"}
    assert set(params["layers"][1]) == set(jdefs["slot1"]) == {"ln1",
                                                              "mlstm"}
    for name in ("mlstm", "slstm"):
        layer = params["layers"][0 if name == "slstm" else 1][name]
        jl = jdefs[f"slot{0 if name == 'slstm' else 1}"][name]
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            k: tuple(d.shape[1:]) for k, d in jl.items()}


@pytest.mark.parametrize("S, ok", ((1, True), (100, True), (128, True),
                                   (256, True), (130, False), (544, False)))
def test_chunk_rule_is_the_references(S, ok):
    """S % min(128, S) == 0, as the reference's chunkwise mLSTM asserts:
    ``check_length`` and ``forward`` refuse the rest."""
    cfg = configs.get_smoke_config(ARCH)
    if ok:
        TX.check_length(S)
        return
    with pytest.raises(ValueError, match="min\\(128, S\\)"):
        TX.check_length(S)
    params = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError):
        forward(params, cfg, tokens=torch.zeros((1, S), dtype=torch.int32))


# -------------------------------------------------------------- blocks


@pytest.mark.parametrize("S, chunk", ((16, 128), (48, 16), (256, 128)))
def test_mlstm_chunkwise_matches_the_reference(S, chunk):
    """One chunk, three of 16 and two of 128, from a non-zero state: h
    and the carried (C, n, m)."""
    B, H, Dh = 2, 4, 16
    q, k, v = (_normal(i, B, S, H, Dh) for i in range(3))
    k = k / 4.0
    li = _normal(3, B, S, H)
    lf = np.log(1.0 / (1.0 + np.exp(-(_normal(4, B, S, H) + 2.0)))
                ).astype(np.float32)
    st = (np.abs(_normal(5, B, H, Dh, Dh)), _normal(6, B, H, Dh),
          _normal(7, B, H))
    h, (C, n, m) = JX._mlstm_chunkwise(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)),
        tuple(jnp.asarray(a) for a in st), chunk=chunk)
    th, (tC, tn, tm) = TX._mlstm_chunkwise(
        *(torch.from_numpy(a) for a in (q, k, v, li, lf)),
        tuple(torch.from_numpy(a) for a in st), chunk=chunk)
    for a, b, what in ((h, th, "h"), (C, tC, "C"), (n, tn, "n"),
                       (m, tm, "m")):
        _close(a, b, what)


@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_blocks_prefill_then_decode_match_the_reference(kind):
    """Layer 1's mLSTM (or layer 0's sLSTM) of the smoke config: a
    prefill of 32 positions from a zero state, then two single steps
    from the carried state (the mLSTM's bf16 conv state among it): the
    outputs and every state leaf."""
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg, 1)
    slot = 0 if kind == "slstm" else 1
    jp = jax.tree.map(lambda a: a[0], params["decoder"][f"slot{slot}"][kind])
    tp = ours["layers"][slot][kind]
    japply = JX.mlstm_apply if kind == "mlstm" else JX.slstm_apply
    tapply = TX.mlstm_apply if kind == "mlstm" else TX.slstm_apply
    x = _normal(2, 2, 34, cfg.d_model)
    jst = tst = None
    for lo, hi in ((0, 32), (32, 33), (33, 34)):
        jo, jst = japply(jp, jnp.asarray(x[:, lo:hi]), cfg, state=jst,
                         return_state=True)
        to, tst = tapply(tp, torch.from_numpy(x[:, lo:hi].copy()), cfg,
                         state=tst, return_state=True)
        _close(jo, to, (kind, lo, "out"))
        assert set(tst) == set(jst)
        for name in jst:
            assert tst[name].dtype == {"bfloat16": torch.bfloat16,
                                       "float32": torch.float32}[
                jnp.dtype(jst[name].dtype).name], name
            _close(jst[name], tst[name], (kind, lo, name))
        tst = _state(jst)    # the next step from the reference's state


# ------------------------------------------------------------- forward


def _with_self_difference(fn, monkeypatch):
    """fn() -> (logits, caches, aux) on the reference, then again with
    its mLSTM's chunks of 4 -> (logits, caches, how far the logits
    moved)."""
    ref, cache, _ = fn()
    with monkeypatch.context() as m:
        m.setattr(JX, "_mlstm_chunkwise",
                  functools.partial(JX._mlstm_chunkwise, chunk=4))
        other = fn()[0]
    ref = _np(ref)
    return ref, cache, float(np.abs(ref - _np(other)).max())


def _assert_caches_close(jcache, tcache, tol):
    """Every leaf within one bf16 step (the conv state) plus ``tol``
    of the leaf's scale."""
    for s, kinds in jcache.items():
        for kind, leaves in kinds.items():
            for n, a in leaves.items():
                b = tcache[s][kind][n]
                assert tuple(a.shape) == tuple(b.shape), (s, kind, n)
                a, b = _np(a), b.float().numpy()
                scale = max(1.0, float(np.abs(a).max()))
                assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a)
                        + tol * scale).all(), (s, kind, n)


def test_forward_f32_matches_the_reference_in_every_mode(monkeypatch):
    """Train at S = 16, prefill at 256 (two mLSTM chunks; the logits and
    every state leaf), then three decode steps from the reference's own
    state."""
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg)
    B, S = 2, 16
    toks = _tokens(cfg, B, S, S)
    ref, _, sd_train = _with_self_difference(
        lambda: JT.forward(params, cfg, tokens=jnp.asarray(toks)),
        monkeypatch)
    for backend in ("cuda", "interpret"):
        got, _, aux = forward(ours, cfg, tokens=torch.as_tensor(toks),
                              mode="train", backend=backend)
        assert got.shape == (B, S, cfg.vocab_size) and aux == {}
        assert _max_abs(ref, got) <= 1e-4 + 8 * sd_train

    S = 256
    toks = _tokens(cfg, B, S, 3)
    ref, jcache, sd = _with_self_difference(
        lambda: JT.forward(params, cfg, tokens=jnp.asarray(toks),
                           mode="prefill",
                           caches=jax_init_cache(cfg, B, S + 8),
                           logits_slice_last=True), monkeypatch)
    bound = 1e-4 + 8 * max(sd, sd_train)
    for backend in ("cuda", "interpret"):
        tcache = init_cache(cfg, B, S + 8, device="cpu")
        got, out, _ = forward(ours, cfg, tokens=torch.as_tensor(toks),
                              mode="prefill", caches=tcache,
                              logits_slice_last=True, backend=backend)
        assert out is tcache
        assert _max_abs(ref, got) <= bound
        _assert_caches_close(jcache, tcache, bound)

    for i in range(3):
        nxt = np.asarray(ref[:, -1].argmax(-1), np.int32)[:, None]
        ref, jnext, _ = JT.forward(params, cfg, tokens=jnp.asarray(nxt),
                                   mode="decode",
                                   index=jnp.array(S + i, jnp.int32),
                                   caches=jcache, logits_slice_last=True)
        ref = _np(ref)
        for backend in ("cuda", "interpret"):
            tcache = _cache_to_torch(jcache)
            got, _, _ = forward(ours, cfg, tokens=torch.from_numpy(nxt),
                                mode="decode", index=S + i, caches=tcache,
                                logits_slice_last=True, backend=backend)
            assert _max_abs(ref, got) <= bound, (i, backend)
            _assert_caches_close(jnext, tcache, bound)
        jcache = jnext


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_decode_through_cache_matches_teacher_forcing(backend):
    """The reference's cache invariant (tests/test_train_serve.py) on the
    recurrent state: prefill and greedy decode against teacher-forced
    forwards (the reference's own agrees on all 12 here)."""
    cfg = jax_smoke(ARCH)
    _, params = _params(cfg, 7)
    B, S, N = 2, 16, 6
    prompt = torch.as_tensor(_tokens(cfg, B, S, 1))
    cache = init_cache(cfg, B, S + N, device="cpu")
    prefill = make_prefill_step(cfg, backend)
    decode = make_decode_step(cfg, backend)
    tok, cache = prefill(params, cache, {"tokens": prompt})
    toks_a = [tok.numpy()]
    for i in range(N - 1):
        tok, cache = decode(params, cache, tok[:, None], S + i)
        toks_a.append(tok.numpy())
    toks_b, cur = [], prompt
    for _ in range(N):
        logits = forward(params, cfg, tokens=cur, mode="train",
                         backend=backend)[0]
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        toks_b.append(nxt.numpy())
        cur = torch.cat([cur, nxt[:, None]], 1)
    agree = np.mean([np.mean(a == b) for a, b in zip(toks_a, toks_b)])
    assert agree >= 0.9, (toks_a, toks_b)


# ----------------------------------------------------------------- engine

REQUESTS = ((5, 6), (9, 6), (3, 4), (7, 8))


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(REQUESTS)]


@pytest.fixture(scope="module")
def reference_run():
    cfg = jax_smoke(ARCH)
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(5))["params"], jnp.float32)
    reqs = _requests(JaxRequest, cfg.vocab_size)
    eng = JaxServeEngine(cfg, params, batch_slots=2, max_seq=32)
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_steps=64)
    return cfg, params, reqs, stats


def _replays(params, ours, cfg, toks, S, n):
    """Both packages' serving logits along the same tokens: a prefill of
    toks[:, :S], then n - 1 decode steps fed toks[:, S + t] ->
    (reference, port) [n, B, V]."""
    B = toks.shape[0]
    jc = jax_init_cache(cfg, B, 32)
    tc = init_cache(cfg, B, 32, device="cpu")
    ref, port = [], []
    for t in range(n):
        lo, hi = (0, S) if t == 0 else (S + t - 1, S + t)
        kw = dict(mode="prefill") if t == 0 else dict(mode="decode")
        x = toks[:, lo:hi]
        lg, jc, _ = JT.forward(params, cfg, tokens=jnp.asarray(x), caches=jc,
                               logits_slice_last=True, **kw, **(
                                   {"index": jnp.array(lo, jnp.int32)}
                                   if t else {}))
        got = forward(ours, cfg, tokens=torch.as_tensor(x), caches=tc,
                      logits_slice_last=True, **kw,
                      **({"index": lo} if t else {}))[0]
        ref.append(_np(lg[:, -1]))
        port.append(got[:, -1].numpy())
    return np.stack(ref), np.stack(port)


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_engine_serves_the_references_tokens(reference_run, backend):
    """The same requests through both engines: the same counts; along
    each batch's reference tokens both packages' serving logits within
    1e-3 (the bf16 conv state's rounding); the served tokens the
    reference's, or first differing where the reference's gap between
    its token and the port's is within twice that step's distance."""
    cfg, params, jreqs, jstats = reference_run
    ours = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    eng = ServeEngine(cfg, ours, batch_slots=2, max_seq=32, backend=backend,
                      device="cpu")
    reqs = _requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_steps=64)
    assert (stats["requests"], stats["tokens"]) == (jstats["requests"],
                                                    jstats["tokens"])
    assert eng.timing["decode_calls"] == 6 + 8
    for i in range(0, len(reqs), 2):
        group, jgroup = reqs[i:i + 2], jreqs[i:i + 2]
        S = max(len(r.prompt) for r in jgroup)
        n = max(r.max_new_tokens for r in jgroup)
        toks = np.zeros((2, S + n), np.int32)
        for j, r in enumerate(jgroup):
            toks[j, S - len(r.prompt):S] = r.prompt
            toks[j, S:S + len(r.out)] = r.out
        ref, port = _replays(params, ours, cfg, toks, S, n)
        dist = np.abs(ref - port).max(-1)
        assert dist.max() <= 1e-3, dist.max()
        for j, (a, b) in enumerate(zip(group, jgroup)):
            assert a.done and len(a.out) == len(b.out)
            diff = np.flatnonzero(np.asarray(a.out) != np.asarray(b.out))
            if diff.size:
                t = int(diff[0])
                gap = ref[t, j, b.out[t]] - ref[t, j, a.out[t]]
                assert gap <= 2 * dist[t, j], (a.rid, t, gap)


def test_conversion_carries_the_recurrent_blocks():
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg, 3)
    dec = params["decoder"]
    for l, layer in enumerate(ours["layers"]):
        p, i = divmod(l, 8)
        kind = "slstm" if i == 0 else "mlstm"
        assert set(layer) == {"ln1", kind}
        for name, a in dec[f"slot{i}"][kind].items():
            np.testing.assert_array_equal(np.asarray(a[p]),
                                          layer[kind][name].numpy())
