"""The hybrid family (Jamba: Mamba mixers, one attention slot per
period, MoE FFNs on every other slot) in the port against the
reference, on CPU tensors: the causal conv, the Mamba block in prefill
and decode, the whole model's ``forward`` in every mode at one and two
periods, the caches, the ``ServeEngine``, the refusals both packages
share, the registry and the weight conversion with an expert share.
Weights come from the reference's init (``init_train_state``), carried
across by ``convert.lm_params_from_reference``; inputs from numpy seeds.

Tolerances:

* the causal conv: 1e-6 (the same f32 products, summed in the same
  order); the Mamba block: 1e-5 (the reference serves a sequence through
  its chunked associative scan, the port through the sequential
  recurrence: K8's plain version on CPU tensors);
* ``forward``, f32 weights: the logits within 1e-4 plus 8 times what the
  reference differs from itself when only its summation orders change
  (``chunked_attention`` against ``attention_ref`` and
  ``_ssm_scan_chunked`` against ``selective_scan_ref``, both the
  reference's), as ``tests/test_torch_lm.py`` bounds the dense family.
  The smoke config has no QK-norm, so the reference's init gives
  attention scores near 100 whose softmax amplifies f32 rounding, and
  Mamba's output RMS norm does the same for a gated output near zero:
  the reference moves by about 5e-5 under these order changes alone.
  The caches' f32 leaves are held to the same bound, their bf16 KV
  leaves to one bf16 step plus it; the MoE aux values to 1e-5.
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
from repro.kernels.selective_scan.ref import (
    selective_scan_ref as jax_scan_ref,
)
from repro.models import attention as JA
from repro.models import registry as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.steps import init_cache as jax_init_cache
from repro.train.step import init_train_state
from repro_torch import configs, convert
from repro_torch.models import registry as TR
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import (
    Slot,
    check_lengths,
    decoder_layout,
    forward,
)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)

ARCH = "jamba-1.5-large-398b"


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_abs(a, b) -> float:
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(_np(a) - b.astype(np.float32)).max())


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


def _cfg(periods: int):
    return dataclasses.replace(jax_smoke(ARCH), num_layers=8 * periods)


def _params(cfg, seed=0):
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(seed))["params"],
        jnp.float32)
    return params, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ----------------------------------------------------------------- layout


def test_layout_is_the_references():
    cfg = jax_smoke(ARCH)
    n_p, slots = decoder_layout(cfg)
    jn_p, jslots = JT.decoder_layout(cfg)
    assert n_p == jn_p == 2
    assert [(s.mixer, s.ffn) for s in slots] == [
        (s.mixer, s.ffn) for s in jslots]
    assert slots[4] == Slot("attn", "moe") and slots[1] == Slot("mamba",
                                                                "dense")
    assert sum(s.ffn == "moe" for s in slots) == 4


# ------------------------------------------------------------ Mamba block


def _mamba_params(cfg, seed=1):
    params, _ = _params(cfg, seed)
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["slot0"]["mamba"])
    return jp, {k: _t(v) for k, v in jp.items()}


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    w = rng.normal(size=(4, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    prev = rng.normal(size=(2, 3, 32)).astype(np.float32)
    for p in (None, prev):
        jo, jprev = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if p is None else jnp.asarray(p))
        to, tprev = TS._causal_conv(_t(x), _t(w), _t(b),
                                    None if p is None else _t(p))
        assert _max_abs(jo, to) <= 1e-6
        assert _max_abs(jprev, tprev) == 0.0
    # bf16 activations: the sum runs in bf16, as the reference's
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jo, _ = JS._causal_conv(xb, wb, jnp.asarray(b), None)
    to, _ = TS._causal_conv(_t(np.asarray(xb)), _t(np.asarray(wb)), _t(b),
                            None)
    assert to.dtype == torch.bfloat16
    assert _max_abs(jo, to) <= 2.0 ** -7 * float(np.abs(_np(jo)).max())


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
@pytest.mark.parametrize("S", (1, 16, 64, 256))
def test_mamba_block_prefill_then_decode_matches(S, backend):
    cfg = jax_smoke(ARCH)
    jp, tp = _mamba_params(cfg)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jout, jst = JS.mamba_apply(jp, jnp.asarray(x), cfg, return_state=True)
    out, st = TS.mamba_apply(tp, _t(x), cfg, return_state=True,
                             backend=backend)
    assert _max_abs(jout, out) <= 1e-5
    assert _max_abs(jst["h"], st["h"]) <= 1e-5
    assert _max_abs(jst["conv"], st["conv"]) <= 1e-6
    assert st["h"].dtype == torch.float32
    # three decode steps, each from the state the last one carried
    for i in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = JS.mamba_apply(jp, jnp.asarray(xt), cfg, state=jst,
                                   return_state=True)
        out, st = TS.mamba_apply(tp, _t(xt), cfg, state=st,
                                 return_state=True, backend=backend)
        assert _max_abs(jout, out) <= 1e-5, i
        assert _max_abs(jst["h"], st["h"]) <= 1e-5, i
        assert _max_abs(jst["conv"], st["conv"]) <= 1e-6, i
    with pytest.raises(KeyError, match="backend"):
        TS.mamba_apply(tp, _t(x), cfg, backend="pallas")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_mamba_block_cuda_backend_takes_the_discretizing_entry(monkeypatch,
                                                              dtype):
    """``backend="cuda"`` hands K8's discretizing entry dt [B, S, di], A
    [di, N], Bm and Cm [B, S, N] (all f32), x in the block's dtype and h0
    [B, di, N], so the block itself builds no [B, S, di, N] tensor; on
    CPU tensors the entry is the eager discretization and the plain
    recurrence, so both backends give the same bits, prefill then
    decode."""
    cfg = jax_smoke(ARCH)
    _, tp = _mamba_params(cfg)
    tp = {k: v.to(dtype) if v.dim() >= 2 else v for k, v in tp.items()}
    di, N = cfg.d_inner, cfg.ssm_d_state
    seen = []

    def spy(dt, A, Bm, Cm, x, h0):
        B, S = dt.shape[:2]
        assert dt.shape == (B, S, di) and A.shape == (di, N)
        assert Bm.shape == Cm.shape == (B, S, N) and x.shape == (B, S, di)
        assert h0.shape == (B, di, N)
        assert {t.dtype for t in (dt, A, Bm, Cm, h0)} == {torch.float32}
        assert x.dtype == dtype
        seen.append(S)
        return TS.selective_scan_discretized_ref(dt, A, Bm, Cm, x, h0)

    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    xt = _t(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    outs = {}
    for backend in ("interpret", "cuda"):
        if backend == "cuda":
            monkeypatch.setattr(TS, "selective_scan_discretized", spy)
        out, st = TS.mamba_apply(tp, x.to(dtype), cfg, return_state=True,
                                 backend=backend)
        dec, st2 = TS.mamba_apply(tp, xt.to(dtype), cfg, state=st,
                                  return_state=True, backend=backend)
        outs[backend] = (out, st["h"], dec, st2["h"])
    assert seen == [16, 1]
    for a, b in zip(outs["cuda"], outs["interpret"]):
        assert torch.equal(a, b)


def test_both_packages_refuse_lengths_the_chunked_scan_cannot_take():
    cfg = jax_smoke(ARCH)
    jp, tp = _mamba_params(cfg)
    x = np.zeros((1, 300, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        JS.mamba_apply(jp, jnp.asarray(x), cfg)
    with pytest.raises(ValueError, match="S=300"):
        TS.mamba_apply(tp, _t(x), cfg)
    for S in (1, 7, 256, 512, 768):       # what both take
        TS.check_length(S)
    # the whole model: S = 300, and B * S = 896 for the MoE grouping
    params, ours = _params(_cfg(1))
    for B, S, rule in ((1, 300, "S=300"), (4, 224, "B\\*S=896")):
        toks = _tokens(_cfg(1), B, S)
        with pytest.raises((AssertionError, TypeError, ValueError)):
            JT.forward(params, _cfg(1), tokens=jnp.asarray(toks))
        with pytest.raises(ValueError, match=rule):
            forward(ours, _cfg(1), tokens=torch.as_tensor(toks))
        with pytest.raises(ValueError, match=rule):
            check_lengths(_cfg(1), B, S)


# ------------------------------------------------------------- forward


def _reference_self_difference(params, cfg, tokens, monkeypatch, **kw):
    """How far the reference moves when its attention's and its scan's
    summation orders change (the reference's own plain versions)."""
    ref = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])

    def via_ref(q, k, v, *, causal, q_offset=0, window=0, kv_chunk=512):
        return jax_attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    def scan_ref(dA, dBx, C, h0, chunk=256):
        return jax_scan_ref(dA, dBx, C, h0)

    with monkeypatch.context() as m:
        m.setattr(JA, "chunked_attention", via_ref)
        m.setattr(JS, "_ssm_scan_chunked", scan_ref)
        other = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])
    return ref, float(np.abs(ref - other).max())


def _cache_to_torch(cache) -> dict:
    return {s: {k: {n: _t(np.asarray(a)) for n, a in d.items()}
                for k, d in v.items()} for s, v in cache.items()}


def _assert_caches_close(jcache, tcache, tol):
    assert set(jcache) == set(tcache)
    for s in jcache:
        assert set(jcache[s]) == set(tcache[s]), s
        for kind in jcache[s]:
            assert set(jcache[s][kind]) == set(tcache[s][kind])
            for n, a in jcache[s][kind].items():
                b = tcache[s][kind][n]
                assert tuple(a.shape) == tuple(b.shape), (s, kind, n)
                assert jnp.dtype(a.dtype).name == str(b.dtype).split(".")[-1]
                a, b = _np(a), b.float().numpy()
                slack = 2.0 ** -7 * np.abs(a) if kind == "kv" else 0.0
                assert (np.abs(a - b) <= slack + tol).all(), (
                    s, kind, n, float(np.abs(a - b).max()))


def _assert_aux_close(jaux, aux):
    assert set(aux) == set(jaux) == {"moe_lb_loss", "moe_z_loss",
                                     "moe_drop_frac"}
    for k in aux:
        assert aux[k].shape == () and _max_abs(jaux[k], aux[k]) <= 1e-5, k


@pytest.mark.parametrize("periods", (1, 2))
def test_forward_f32_matches_the_reference_in_every_mode(periods,
                                                        monkeypatch):
    cfg = _cfg(periods)
    params, ours = _params(cfg)
    B, S = 2, 16
    toks = _tokens(cfg, B, S)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)

    # train, with the MoE aux summed over the layers
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

    # prefill: the last position's logits and every slot's cache
    jcache = jax_init_cache(cfg, B, S + 4)
    ref, jcache, jaux = JT.forward(params, cfg, tokens=jt, mode="prefill",
                                   caches=jcache, logits_slice_last=True)
    tcache = init_cache(cfg, B, S + 4, device="cpu")
    got, out_cache, aux = forward(ours, cfg, tokens=tt, mode="prefill",
                                  caches=tcache, logits_slice_last=True)
    assert out_cache is tcache
    assert got.shape == (B, 1, cfg.vocab_size)
    assert _max_abs(ref, got) <= bound
    _assert_caches_close(jcache, tcache, bound)
    _assert_aux_close(jaux, aux)

    # decode from the reference's own cache, so only the step differs
    nxt = np.asarray(jnp.argmax(ref[:, -1], -1), np.int32)[:, None]
    ref, jcache2, jaux = JT.forward(
        params, cfg, tokens=jnp.asarray(nxt), mode="decode",
        index=jnp.array(S, jnp.int32), caches=jcache,
        logits_slice_last=True)
    for backend in ("cuda", "interpret"):
        tcache = _cache_to_torch(jcache)
        got, _, aux = forward(ours, cfg, tokens=torch.from_numpy(nxt.copy()),
                              mode="decode", index=S, caches=tcache,
                              logits_slice_last=True, backend=backend)
        assert _max_abs(ref, got) <= bound
        _assert_caches_close(jcache2, tcache, bound)
        _assert_aux_close(jaux, aux)


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_decode_through_cache_matches_teacher_forcing(backend):
    """The reference's cache invariant (tests/test_train_serve.py) on the
    hybrid stack: greedy decode through the KV cache and the carried
    Mamba state reproduces the argmax chain of full forwards.  Which
    tokens the MoE capacity drops depends on how the tokens are grouped
    (a prefill of 32 tokens, decode steps of 2, full forwards of up to
    42), so the invariant holds only where no token is dropped: at the
    smoke's capacity factor 1.25 the reference itself agrees on 0.58 of
    the positions.  ``capacity_factor`` 2 gives every expert room for
    every token of a group (C = g * k / E * 2 = g at E / k = 2)."""
    cfg = dataclasses.replace(_cfg(1), capacity_factor=2.0)
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

# (prompt length, max_new_tokens): batches of two, left-padded
REQUESTS = ((5, 6), (9, 6), (3, 4), (7, 8))


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(REQUESTS)]


@pytest.fixture(scope="module")
def reference_run():
    cfg = _cfg(1)
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(5))["params"], jnp.float32)
    reqs = _requests(JaxRequest, cfg.vocab_size)
    eng = JaxServeEngine(cfg, params, batch_slots=2, max_seq=32)
    for r in reqs:
        eng.submit(r)
    # one budget covers every batch's decode steps (6 + 8)
    stats = eng.run(max_steps=64)
    return cfg, params, reqs, stats


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_engine_serves_the_references_tokens(reference_run, backend):
    cfg, params, jreqs, jstats = reference_run
    ours = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    eng = ServeEngine(cfg, ours, batch_slots=2, max_seq=32, backend=backend,
                      device="cpu")
    assert eng.backend == ("cpu-ref" if backend == "cuda" else "interpret")
    reqs = _requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_steps=64)
    assert (stats["requests"], stats["tokens"]) == (jstats["requests"],
                                                    jstats["tokens"])
    assert eng.timing["prefill_calls"] == 2
    assert eng.timing["decode_calls"] == 6 + 8
    for a, b in zip(reqs, jreqs):
        assert a.done and len(a.out) == len(b.out)
        diff = np.flatnonzero(np.asarray(a.out) != np.asarray(b.out))
        if diff.size:   # only where the reference's top two are close
            t = int(diff[0])
            seq = np.concatenate([b.prompt, b.out[:t]])[None]
            row = _np(JT.forward(params, cfg, tokens=jnp.asarray(
                seq.astype(np.int32)))[0])[0, -1]
            assert abs(row[b.out[t]] - row[a.out[t]]) <= 1e-3, (a.rid, t)


# --------------------------------------------------- registry, conversion


def test_registry_follows_the_reference():
    full = configs.get_config(ARCH)
    assert full.param_count() == jax_get_config(ARCH).param_count()
    assert TR.param_count(full) == JR.param_count(jax_get_config(ARCH))
    cfg = configs.get_smoke_config(ARCH)
    jc = JR.cache_defs(jax_smoke(ARCH), 3, 20)
    tc = TR.cache_defs(cfg, 3, 20)
    assert {s: {k: {n: (tuple(d.shape), jnp.dtype(d.dtype).name)
                    for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in jc.items()} \
        == {s: {k: {n: (d.shape, str(d.dtype).split(".")[-1])
                    for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in tc.items()}
    # init: per-slot trees, the expert share, A_log = log(1..N)
    params = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", experts=range(2, 4))
    jdefs = JR.param_defs(jax_smoke(ARCH))
    P = len(jdefs["decoder"])
    assert len(params["layers"]) == cfg.num_layers
    for l, layer in enumerate(params["layers"]):
        jslot = jdefs["decoder"][f"slot{l % P}"]
        for path, d in jax.tree_util.tree_flatten_with_path(
                jslot, is_leaf=pt.is_def)[0]:
            keys = [p.key for p in path]
            t = layer
            for k in keys:
                t = t[k]
            shape = list(d.shape[1:])
            if keys[-1] in ("wg", "wu", "wd") and "router" in layer["ffn"]:
                shape[0] = 2
            assert list(t.shape) == shape, (l, keys)
            want = torch.bfloat16 if len(shape) >= 2 else torch.float32
            assert t.dtype == want, keys
    a_log = params["layers"][0]["mamba"]["A_log"]
    want = torch.log(torch.arange(1, cfg.ssm_d_state + 1,
                                  dtype=torch.float32))
    assert torch.equal(a_log, want.expand_as(a_log).to(torch.bfloat16))


def test_conversion_orders_layers_and_slices_the_expert_share():
    cfg = _cfg(2)
    params, _ = _params(cfg, 3)
    share = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu", experts=range(1, 3))
    dec = params["decoder"]
    assert len(share["layers"]) == 16
    for l, layer in enumerate(share["layers"]):
        p, i = divmod(l, 8)
        slot = dec[f"slot{i}"]
        mixer = "attn" if i == 4 else "mamba"
        assert set(layer) == {"ln1", mixer, "ln2", "ffn"}
        w = next(iter(slot[mixer].values()))
        np.testing.assert_array_equal(
            np.asarray(w[p]), next(iter(layer[mixer].values())).numpy())
        if i % 2 == 0:
            np.testing.assert_array_equal(np.asarray(slot["ffn"]["wg"][p,
                                                                      1:3]),
                                          layer["ffn"]["wg"].numpy())
            np.testing.assert_array_equal(np.asarray(slot["ffn"]["router"][
                p]), layer["ffn"]["router"].numpy())
    with pytest.raises(ValueError, match="contiguous"):
        convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                         device="cpu", experts=[0, 3])
