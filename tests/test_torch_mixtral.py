"""Mixtral-8x7B (the MoE family with a sliding window: 8 experts top-2
and a 4,096-key window at full size, 32 in the smoke config) in the port
against the reference, on CPU tensors: the configs and the parameter
count, the rolling KV cache (``cache_update_tree`` at ``index % T``,
decode over the written slots against
``repro.models.attention.decode_attention(window=)``), the reference's
cache layout after a prompt longer than the window, ``forward`` in f32
in every mode, decode through the ring against teacher forcing, and the
``ServeEngine`` serving the reference's tokens.  Weights come from the
reference's init, carried across by ``convert.lm_params_from_reference``;
inputs from numpy seeds.

Tolerances, as ``tests/test_torch_moonshot.py`` holds the MoE family:

* the cache update: exact (the same values written at the same slots);
  the attention functions, f32: 1e-5 max abs;
* ``forward``, f32 weights: the logits within 1e-4 plus 8 times what the
  reference differs from itself when only its attention's summation
  order changes (``chunked_attention`` against ``attention_ref``, both
  the reference's); decode from the reference's own cache, so only the
  step differs; the MoE aux values within 1e-5 of max(1, |value|) (the
  z-loss reaches 10 here);
* the engine: the same token counts, and tokens equal or first differing
  only where the reference's own top two logits lie within twice the
  two packages' logit distance along the reference's serving path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pytree as pt
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.models import attention as JA
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.steps import init_cache as jax_init_cache
from repro.train.step import init_train_state
from repro_torch import configs, convert
from repro_torch.models import attention as TA
from repro_torch.models import registry as TR
from repro_torch.models.transformer import decoder_layout, forward
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)

ARCH = "mixtral-8x7b"
WINDOW = 32          # the smoke config's sliding window
TOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_abs(a, b) -> float:
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(_np(a) - b.astype(np.float32)).max())


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


def _params(cfg, seed=0):
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(seed))["params"],
        jnp.float32)
    return params, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cache_to_torch(cache) -> dict:
    return {s: {k: {n: _t(np.asarray(a)) for n, a in d.items()}
                for k, d in v.items()} for s, v in cache.items()}


# ------------------------------------------------- configs and layout


def test_configs_and_param_count_are_the_references():
    for ours, ref in ((configs.get_config(ARCH), jax_get_config(ARCH)),
                      (configs.get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert TR.param_count(ours) == JR.param_count(ref)
    full = configs.get_config(ARCH)
    assert (full.family, full.num_layers, full.num_experts,
            full.num_experts_per_tok, full.sliding_window) == (
        "moe", 32, 8, 2, 4096)
    # 93.4 GB of bf16 weights: more than the card's 80 GB, so the card
    # serves a share of the experts (chip_smoke.py: experts 0-3)
    assert 46.6e9 < TR.param_count(full) < 46.8e9
    n_p, slots = decoder_layout(full)
    assert n_p == 32 and [(s.mixer, s.ffn) for s in slots] == [
        ("attn", "moe")]


@pytest.mark.parametrize("max_seq", (20, 32, 40, 4352))
def test_cache_holds_min_of_max_seq_and_window(max_seq):
    cfg = configs.get_smoke_config(ARCH)
    kv = TR.cache_defs(cfg, 3, max_seq)["slot0"]["kv"]
    jkv = JR.cache_defs(jax_smoke(ARCH), 3, max_seq)["slot0"]["kv"]
    T = min(max_seq, WINDOW)
    assert kv["k"].shape == tuple(jkv["k"].shape) == (
        cfg.num_layers, 3, T, cfg.num_kv_heads, cfg.head_dim)
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    assert TA.cache_defs(int8, 3, max_seq, 4)["k_scale"].shape == (4, 3, T, 2)


# ----------------------------------------------------- the rolling cache


@pytest.mark.parametrize("kind", ("bf16", "int8"))
@pytest.mark.parametrize("index", (0, 5, 31, 32, 45, 77))
def test_rolling_cache_update_writes_index_mod_T(kind, index):
    """``cache_update_tree(window=)`` writes position ``index`` at slot
    ``index % T``, in place, and leaves every other slot as it was: the
    reference's tree, value for value."""
    B, T, K, D = 2, WINDOW, 2, 16
    k, v = _normal(1, B, 1, K, D), _normal(2, B, 1, K, D)
    if kind == "bf16":
        jkv = {"k": jnp.asarray(_normal(3, B, T, K, D), jnp.bfloat16),
               "v": jnp.asarray(_normal(4, B, T, K, D), jnp.bfloat16)}
    else:
        jkv = {n: jnp.asarray(np.random.default_rng(i).integers(
            -127, 128, (B, T, K, D)), jnp.int8) for i, n in ((5, "k"),
                                                            (6, "v"))}
        jkv |= {n: jnp.asarray(np.abs(_normal(i, B, T, K)))
                for i, n in ((7, "k_scale"), (8, "v_scale"))}
    ours = {n: _t(np.asarray(a)) for n, a in jkv.items()}
    before = {n: t.clone() for n, t in ours.items()}
    want = JA.cache_update_tree(jkv, jnp.asarray(k), jnp.asarray(v),
                                jnp.array(index, jnp.int32), window=WINDOW)
    got = TA.cache_update_tree(ours, torch.from_numpy(k),
                               torch.from_numpy(v), index, window=WINDOW)
    assert got is ours
    slot = index % T
    for n, a in want.items():
        np.testing.assert_array_equal(_np(a), got[n].float().numpy())
        keep = torch.ones(T, dtype=torch.bool)
        keep[slot] = False
        assert torch.equal(got[n][:, keep], before[n][:, keep]), n


@pytest.mark.parametrize("index", (0, 3, 30, 31, 32, 50, 200))
def test_windowed_decode_attends_every_written_slot(index):
    """Decode against a rolling cache attends slots < min(index + 1, T),
    with no position mask: ``decode_attention(window=)`` and the tree
    form on both engines (K7's plain version over skv = that count on
    CPU tensors) against the reference's."""
    B, T, H, K, D = 2, WINDOW, 4, 2, 16
    q = _normal(0, B, 1, H, D)
    kc, vc = _normal(1, B, T, K, D), _normal(2, B, T, K, D)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.array(index, jnp.int32),
                               window=WINDOW)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    assert _max_abs(want, TA.decode_attention(tq, tk, tv, index,
                                              window=WINDOW)) <= TOL
    for backend in ("cuda", "interpret"):
        got = TA.decode_attention_tree(tq, {"k": tk, "v": tv}, index,
                                       backend=backend, window=WINDOW)
        assert _max_abs(want, got) <= TOL, backend


def test_windowed_prefill_attention_matches_the_reference():
    """Causal prefill with the window binding (S = 48 > W = 32), K7's
    plain version and the plain attention against ``chunked_attention``."""
    q = _normal(0, 2, 48, 4, 16)
    k, v = _normal(1, 2, 48, 2, 16), _normal(2, 2, 48, 2, 16)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=WINDOW,
                                kv_chunk=16)
    for backend in ("cuda", "interpret"):
        got = TA.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   backend=backend, window=WINDOW)
        assert _max_abs(want, got) <= TOL, backend


def test_cache_layout_after_a_prompt_longer_than_the_window():
    """A 40-token prompt at window 32: prefill writes the last 32 keys to
    slots 0..31 (slot j holds position 8 + j), and the first decode step
    (index 40) overwrites slot 40 % 32 = 8, which held position 16, not
    the oldest key 8: the reference's layout, kept as it is.  Each of
    the port's slots is nearest the reference's same slot, and the step
    changes slot 8 alone."""
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg, 1)
    B, S = 2, 40
    toks = _tokens(cfg, B, S, 2)
    jcache = jax_init_cache(cfg, B, 64)
    logits, jcache, _ = JT.forward(params, cfg, tokens=jnp.asarray(toks),
                                   mode="prefill", caches=jcache,
                                   logits_slice_last=True)
    tcache = init_cache(cfg, B, 64, device="cpu")
    forward(ours, cfg, tokens=torch.as_tensor(toks), mode="prefill",
            caches=tcache, logits_slice_last=True)
    for name in ("k", "v"):
        a = _np(jcache["slot0"]["kv"][name])          # [L, B, T, K, D]
        b = tcache["slot0"]["kv"][name].float().numpy()
        assert a.shape == b.shape == (cfg.num_layers, B, WINDOW, 2, 16)
        d = np.abs(a[:, :, :, None] - b[:, :, None, :]).sum(axis=(0, 1, 4,
                                                                   5))
        np.testing.assert_array_equal(d.argmin(axis=0), np.arange(WINDOW))
    # slot j holds position 8 + j: layer 0's keys, projected alone
    lp = ours["layers"][0]
    from repro_torch.models.layers import embed, rmsnorm
    h = rmsnorm(lp["ln1"], embed(ours["embed"], torch.as_tensor(toks)))
    k, _ = TA.project_kv(lp["attn"], h, cfg, torch.arange(S))
    assert torch.equal(tcache["slot0"]["kv"]["k"][0],
                       k[:, S - WINDOW:].to(torch.bfloat16))
    # the first decode step writes slot 8 in both
    nxt = np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)[:, None]
    before = tcache["slot0"]["kv"]["k"].clone()
    _, jc2, _ = JT.forward(params, cfg, tokens=jnp.asarray(nxt),
                           mode="decode", index=jnp.array(S, jnp.int32),
                           caches=jcache, logits_slice_last=True)
    forward(ours, cfg, tokens=torch.as_tensor(nxt), mode="decode", index=S,
            caches=tcache, logits_slice_last=True)
    after = tcache["slot0"]["kv"]["k"]
    changed = (after != before).any(dim=(0, 1, 3, 4))
    assert torch.nonzero(changed).flatten().tolist() == [S % WINDOW]
    jchanged = (_np(jc2["slot0"]["kv"]["k"]) != _np(jcache["slot0"]["kv"][
        "k"])).any(axis=(0, 1, 3, 4))
    assert np.flatnonzero(jchanged).tolist() == [S % WINDOW]


# ------------------------------------------------------------- forward


def _reference_self_difference(params, cfg, tokens, monkeypatch, **kw):
    ref = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])

    def via_ref(q, k, v, *, causal, q_offset=0, window=0, kv_chunk=512):
        return jax_attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    with monkeypatch.context() as m:
        m.setattr(JA, "chunked_attention", via_ref)
        other = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])
    return ref, float(np.abs(ref - other).max())


def _assert_aux_close(jaux, aux):
    assert set(aux) == set(jaux) == {"moe_lb_loss", "moe_z_loss",
                                     "moe_drop_frac"}
    for k in aux:
        assert aux[k].shape == () and _max_abs(jaux[k], aux[k]) <= 1e-5 * (
            max(1.0, abs(float(jaux[k])))), k


def _assert_cache_close(jcache, tcache, tol):
    for n, a in jcache["slot0"]["kv"].items():
        b = tcache["slot0"]["kv"][n]
        assert tuple(a.shape) == tuple(b.shape), n
        a, b = _np(a), b.float().numpy()
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + tol).all(), (
            n, float(np.abs(a - b).max()))


def test_forward_f32_matches_the_reference_in_every_mode(monkeypatch):
    """S = 40 > the window: train and prefill with the window binding,
    then four decode steps through the ring (slots 8..11)."""
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg)
    B, S = 2, 40
    toks = _tokens(cfg, B, S)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)

    ref, self_diff = _reference_self_difference(params, cfg, jt,
                                                monkeypatch)
    bound = 1e-4 + 8 * self_diff
    jaux = JT.forward(params, cfg, tokens=jt)[2]
    for backend in ("cuda", "interpret"):
        got, _, aux = forward(ours, cfg, tokens=tt, mode="train",
                              backend=backend)
        assert got.shape == (B, S, cfg.vocab_size)
        assert _max_abs(ref, got) <= bound, (self_diff, bound)
        _assert_aux_close(jaux, aux)

    jcache = jax_init_cache(cfg, B, 64)
    ref, jcache, jaux = JT.forward(params, cfg, tokens=jt, mode="prefill",
                                   caches=jcache, logits_slice_last=True)
    tcache = init_cache(cfg, B, 64, device="cpu")
    got, out_cache, aux = forward(ours, cfg, tokens=tt, mode="prefill",
                                  caches=tcache, logits_slice_last=True)
    assert out_cache is tcache
    assert _max_abs(ref, got) <= bound
    _assert_cache_close(jcache, tcache, bound)
    _assert_aux_close(jaux, aux)

    for i in range(4):
        nxt = np.asarray(jnp.argmax(ref[:, -1], -1), np.int32)[:, None]
        ref, jnext, jaux = JT.forward(
            params, cfg, tokens=jnp.asarray(nxt), mode="decode",
            index=jnp.array(S + i, jnp.int32), caches=jcache,
            logits_slice_last=True)
        for backend in ("cuda", "interpret"):
            tcache = _cache_to_torch(jcache)
            got, _, aux = forward(ours, cfg, tokens=torch.from_numpy(nxt),
                                  mode="decode", index=S + i, caches=tcache,
                                  logits_slice_last=True, backend=backend)
            assert _max_abs(ref, got) <= bound, (i, backend)
            _assert_cache_close(jnext, tcache, bound)
            _assert_aux_close(jaux, aux)
        jcache = jnext


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
@pytest.mark.parametrize("S, N", ((32, 8), (24, 16)))
def test_decode_through_cache_matches_teacher_forcing(backend, S, N):
    """The reference's cache invariant (tests/test_train_serve.py) through
    the ring at window 32: a 32-token prompt whose first decode step
    writes slot 0 (the oldest key), and a 24-token one whose decode
    wraps after 8 steps, against teacher forcing, the windowed causal
    forward over up to 39 positions.  (A prompt longer than the window
    leaves the reference's layout, where the first step overwrites
    another key than the oldest: the reference's own invariant then
    falls to 0.125 at S = 36, so it is held by
    ``test_cache_layout_after_a_prompt_longer_than_the_window``
    instead.)  Drop-free (``capacity_factor`` E / k), as
    ``tests/test_torch_moonshot.py`` holds the MoE stack."""
    base = jax_smoke(ARCH)
    cfg = dataclasses.replace(
        base, capacity_factor=base.num_experts / base.num_experts_per_tok)
    _, params = _params(cfg, 7)
    B = 2
    prompt = torch.as_tensor(_tokens(cfg, B, S, 1))
    cache = init_cache(cfg, B, S + N, device="cpu")
    assert cache["slot0"]["kv"]["k"].shape[2] == WINDOW
    prefill = make_prefill_step(cfg, backend)
    decode = make_decode_step(cfg, backend)
    tok, cache = prefill(params, cache, {"tokens": prompt})
    toks_a = [tok.numpy()]
    for i in range(N - 1):
        tok, cache = decode(params, cache, tok[:, None], S + i)
        toks_a.append(tok.numpy())
    toks_b, cur = [], prompt
    for _ in range(N):
        logits, _, aux = forward(params, cfg, tokens=cur, mode="train",
                                 backend=backend)
        assert float(aux["moe_drop_frac"]) == 0.0
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        toks_b.append(nxt.numpy())
        cur = torch.cat([cur, nxt[:, None]], 1)
    agree = np.mean([np.mean(a == b) for a, b in zip(toks_a, toks_b)])
    assert agree >= 0.9, (toks_a, toks_b)


# ----------------------------------------------------------------- engine

# (prompt length, max_new_tokens): batches of two, left-padded; the first
# batch's prompts pass the window, so its decode writes the ring
REQUESTS = ((36, 6), (40, 6), (3, 4), (7, 8))


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
    eng = JaxServeEngine(cfg, params, batch_slots=2, max_seq=64)
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_steps=64)
    return cfg, params, reqs, stats


def _replays(params, ours, cfg, toks, S, n):
    """Both packages' serving logits along the same tokens: a prefill of
    toks[:, :S], then n - 1 decode steps fed toks[:, S + t] ->
    (reference, port) [n, B, V]."""
    B = toks.shape[0]
    jc = jax_init_cache(cfg, B, 64)
    tc = init_cache(cfg, B, 64, device="cpu")
    ref, port = [], []
    for t in range(n):
        lo, hi = (0, S) if t == 0 else (S + t - 1, S + t)
        x = toks[:, lo:hi]
        if t == 0:
            lg, jc, _ = JT.forward(params, cfg, tokens=jnp.asarray(x),
                                   mode="prefill", caches=jc,
                                   logits_slice_last=True)
            got = forward(ours, cfg, tokens=torch.as_tensor(x),
                          mode="prefill", caches=tc,
                          logits_slice_last=True)[0]
        else:
            lg, jc, _ = JT.forward(params, cfg, tokens=jnp.asarray(x),
                                   mode="decode",
                                   index=jnp.array(lo, jnp.int32),
                                   caches=jc, logits_slice_last=True)
            got = forward(ours, cfg, tokens=torch.as_tensor(x),
                          mode="decode", index=lo, caches=tc,
                          logits_slice_last=True)[0]
        ref.append(_np(lg[:, -1]))
        port.append(got[:, -1].numpy())
    return np.stack(ref), np.stack(port)


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_engine_serves_the_references_tokens(reference_run, backend):
    """The same requests through both engines: the same counts, the
    ring's cache; the served tokens the reference's, or first differing
    where the reference's gap between its token and the port's, along
    its own serving path, is within twice the two packages' logit
    distance there (its scores near 100 make a bf16 rounding flip in
    either package's cache move the logits by O(1), so that distance is
    reported by the assertion, not bounded)."""
    cfg, params, jreqs, jstats = reference_run
    ours = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    eng = ServeEngine(cfg, ours, batch_slots=2, max_seq=64, backend=backend,
                      device="cpu")
    assert eng.cache["slot0"]["kv"]["k"].shape[2] == WINDOW
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
        for j, (a, b) in enumerate(zip(group, jgroup)):
            assert a.done and len(a.out) == len(b.out)
            diff = np.flatnonzero(np.asarray(a.out) != np.asarray(b.out))
            if diff.size:
                t = int(diff[0])
                gap = ref[t, j, b.out[t]] - ref[t, j, a.out[t]]
                assert gap <= 2 * dist[t, j], (a.rid, t, gap, dist[t, j])
