"""The MoE family (Moonshot-v1-16B-A3B: an attention layer and an MoE FFN
in every layer, 64 experts top-6 at full size) in the port against the
reference, on CPU tensors: the configs field for field and the parameter
count, the layout, the smoke config's ``forward`` in f32 in every mode,
decode through the cache against teacher forcing, and the
``ServeEngine`` serving the reference's tokens.  Weights come from the
reference's init (``init_train_state``), carried across by
``convert.lm_params_from_reference``; inputs from numpy seeds.

Tolerances, as ``tests/test_torch_lm.py`` and
``tests/test_torch_hybrid.py`` hold the dense and hybrid families:

* ``forward``, f32 weights: the logits within 1e-4 plus 8 times what the
  reference differs from itself when only its attention's summation
  order changes (``chunked_attention`` against ``attention_ref``, both
  the reference's).  The smoke config has no QK-norm, so the reference's
  init gives attention scores near 100 whose softmax amplifies f32
  rounding.  The bf16 KV cache leaves within one bf16 step plus that
  bound; the MoE aux values within 1e-5.
* the engine: the same token counts, and tokens equal or first differing
  only where the reference's own top two logits lie within 1e-3.
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
from repro_torch.models import registry as TR
from repro_torch.models.transformer import Slot, decoder_layout, forward
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)

ARCH = "moonshot-v1-16b-a3b"


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


# ------------------------------------------------- configs and layout


def test_configs_and_param_count_are_the_references():
    for ours, ref in ((configs.get_config(ARCH), jax_get_config(ARCH)),
                      (configs.get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert TR.param_count(ours) == JR.param_count(ref)
    full = configs.get_config(ARCH)
    assert (full.family, full.num_layers, full.num_experts,
            full.num_experts_per_tok) == ("moe", 48, 64, 6)
    # 56.1 GB of bf16 weights: the card's 80 GB hold them
    assert 56.0e9 < 2 * TR.param_count(full) < 56.2e9


def test_layout_is_the_references():
    for cfg in (jax_smoke(ARCH), jax_get_config(ARCH)):
        n_p, slots = decoder_layout(cfg)
        jn_p, jslots = JT.decoder_layout(cfg)
        assert n_p == jn_p == cfg.num_layers
        assert [(s.mixer, s.ffn) for s in slots] == [
            (s.mixer, s.ffn) for s in jslots] == [("attn", "moe")]
    assert decoder_layout(jax_smoke(ARCH))[1] == [Slot("attn", "moe")]


def test_registry_follows_the_reference():
    cfg = configs.get_smoke_config(ARCH)
    jc = JR.cache_defs(jax_smoke(ARCH), 3, 20)
    tc = TR.cache_defs(cfg, 3, 20)
    assert {s: {k: {n: (tuple(d.shape), jnp.dtype(d.dtype).name)
                    for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in jc.items()} \
        == {s: {k: {n: (d.shape, str(d.dtype).split(".")[-1])
                    for n, d in leaves.items()}
                for k, leaves in tree.items()} for s, tree in tc.items()}
    params = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    jslot = JR.param_defs(jax_smoke(ARCH))["decoder"]["slot0"]
    for layer in params["layers"]:
        assert set(layer) == set(jslot) == {"ln1", "attn", "ln2", "ffn"}
        ffn = layer["ffn"]
        assert tuple(ffn["router"].shape) == (cfg.d_model, cfg.num_experts)
        assert tuple(ffn["wg"].shape) == (cfg.num_experts, cfg.d_model,
                                          cfg.d_ff)
        assert tuple(ffn["wd"].shape) == (cfg.num_experts, cfg.d_ff,
                                          cfg.d_model)


# ------------------------------------------------------------- forward


def _reference_self_difference(params, cfg, tokens, monkeypatch, **kw):
    """How far the reference moves when its attention's summation order
    changes: chunked_attention against attention_ref."""
    ref = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])

    def via_ref(q, k, v, *, causal, q_offset=0, window=0, kv_chunk=512):
        return jax_attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)

    with monkeypatch.context() as m:
        m.setattr(JA, "chunked_attention", via_ref)
        other = _np(JT.forward(params, cfg, tokens=tokens, **kw)[0])
    return ref, float(np.abs(ref - other).max())


def _cache_to_torch(cache) -> dict:
    return {s: {k: {n: _t(np.asarray(a)) for n, a in d.items()}
                for k, d in v.items()} for s, v in cache.items()}


def _assert_caches_close(jcache, tcache, tol):
    assert set(jcache) == set(tcache) == {"slot0"}
    for n, a in jcache["slot0"]["kv"].items():
        b = tcache["slot0"]["kv"][n]
        assert tuple(a.shape) == tuple(b.shape), n
        a, b = _np(a), b.float().numpy()
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + tol).all(), (
            n, float(np.abs(a - b).max()))


def _assert_aux_close(jaux, aux):
    assert set(aux) == set(jaux) == {"moe_lb_loss", "moe_z_loss",
                                     "moe_drop_frac"}
    for k in aux:
        assert aux[k].shape == () and _max_abs(jaux[k], aux[k]) <= 1e-5, k


def test_forward_f32_matches_the_reference_in_every_mode(monkeypatch):
    cfg = jax_smoke(ARCH)
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

    # prefill: the last position's logits and the cache
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
    MoE stack.  Which tokens the capacity drops depends on how the tokens
    are grouped (a prefill of 32, decode steps of 2, full forwards of up
    to 42), so the invariant holds where no token is dropped:
    ``capacity_factor`` E / k gives every expert room for every token of
    a group."""
    base = jax_smoke(ARCH)
    cfg = dataclasses.replace(
        base, capacity_factor=base.num_experts / base.num_experts_per_tok)
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
        logits, _, aux = forward(params, cfg, tokens=cur, mode="train",
                                 backend=backend)
        assert float(aux["moe_drop_frac"]) == 0.0
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
    cfg = jax_smoke(ARCH)
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(5))["params"], jnp.float32)
    reqs = _requests(JaxRequest, cfg.vocab_size)
    eng = JaxServeEngine(cfg, params, batch_slots=2, max_seq=32)
    for r in reqs:
        eng.submit(r)
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


def test_conversion_carries_every_layer_and_expert():
    cfg = jax_smoke(ARCH)
    params, ours = _params(cfg, 3)
    dec = params["decoder"]["slot0"]
    assert len(ours["layers"]) == cfg.num_layers
    for l, layer in enumerate(ours["layers"]):
        for name in ("router", "wg", "wu", "wd"):
            np.testing.assert_array_equal(np.asarray(dec["ffn"][name][l]),
                                          layer["ffn"][name].numpy())
        np.testing.assert_array_equal(np.asarray(dec["attn"]["wq"][l]),
                                      layer["attn"]["wq"].numpy())
    share = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu", experts=range(2, 5))
    np.testing.assert_array_equal(np.asarray(dec["ffn"]["wu"][1, 2:5]),
                                  share["layers"][1]["ffn"]["wu"].numpy())
