"""The port's LM stack (configs, layers, attention and its caches, the
decoder forward, the registry, the weight conversion) against the
reference on the dense smoke configs, on CPU tensors.

Tolerances:

* layers and the attention module, f32: 1e-5 max abs;
* quantize_kv: the int8 values and scales exactly, given equal inputs;
* ``forward``, f32 weights: the logits within 1e-4 plus 8 times what the
  reference differs from itself when only its attention's summation
  order changes (``chunked_attention`` against ``attention_ref``, both
  the reference's).  With QK-norm (qwen3) that difference is about 3e-7
  and the bound is 1e-4.  Without it the reference's init (``wq``'s
  fan-in is its head axis) gives attention scores near 100, whose
  softmax turns f32 rounding into output changes: the reference differs
  from itself by up to 7e-5 there, and the port by 3-7 times that.
* ``forward``, bf16 weights (``cast_for_compute``): a bf16 rounding flip
  in either framework moves the logits by 0.004 with QK-norm and by up
  to about 1 without it (one bf16 step of a score near 100 is 0.5), so
  the bound is 0.02 with QK-norm and 1.0 without, the median row's
  largest difference must stay under 0.1, and greedy tokens may differ
  only where the reference's top-two margin is within the bound (the
  count is reported).
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
from repro.configs import list_archs as jax_list_archs
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.serve.steps import init_cache as jax_init_cache
from repro.train.step import cast_for_compute, init_train_state
from repro_torch import configs, convert
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.models.transformer import (
    decoder_layout,
    encoder_layout,
    forward,
)
from repro_torch.serve.steps import (
    init_cache,
    make_decode_step,
    make_prefill_step,
)

DENSE = ("qwen3-1.7b", "qwen2-7b", "starcoder2-15b", "qwen1.5-32b")
ARCHS = DENSE + ("jamba-1.5-large-398b", "moonshot-v1-16b-a3b",
                 "mixtral-8x7b", "llama-3.2-vision-11b",
                 "seamless-m4t-large-v2", "xlstm-1.3b")
TOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_abs(a, b) -> float:
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(_np(a) - b.astype(np.float32)).max())


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- configs


def test_dense_configs_are_the_references_field_for_field():
    """Every architecture of the reference, published and smoke."""
    assert configs.list_archs() == sorted(ARCHS) == jax_list_archs()
    for name in ARCHS:
        for ours, ref in ((configs.get_config(name), jax_get_config(name)),
                          (configs.get_smoke_config(name), jax_smoke(name))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.param_count() == ref.param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("mixtral-8x22b")


def _def_tree(tree) -> dict:
    """A cache-defs tree of either package -> {path: (shape, dtype)}."""
    out = {}
    for slot, kinds in tree.items():
        for kind, leaves in kinds.items():
            for name, d in leaves.items():
                shape, dt = ((d.shape, jnp.dtype(d.dtype).name)
                             if not isinstance(d.dtype, torch.dtype) else
                             (d.shape, str(d.dtype).split(".")[-1]))
                out[f"{slot}/{kind}/{name}"] = (tuple(shape), dt)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_other_families_and_windows_raise_with_their_roadmap_item(name):
    """No family raises any more: for every architecture's smoke config
    the decoder layout, the cache tree's shapes and dtypes (a window
    shorter and longer than the cache) and the parameter count are the
    reference's; an unknown family raises ValueError, as the
    reference's layout does."""
    cfg = configs.get_smoke_config(name)
    n_p, slots = decoder_layout(cfg)
    jn_p, jslots = JT.decoder_layout(jax_smoke(name))
    assert n_p == jn_p
    assert [(s.mixer, s.ffn, s.cross, s.gated_cross) for s in slots] == [
        (s.mixer, s.ffn, s.cross, s.gated_cross) for s in jslots]
    if cfg.family == "encdec":
        assert (encoder_layout(cfg)[0], [s.mixer for s in encoder_layout(
            cfg)[1]]) == (JT.encoder_layout(cfg)[0], ["attn_nc"])
    for batch, max_seq in ((1, 8), (3, 40)):
        assert _def_tree(TR.cache_defs(cfg, batch, max_seq)) == _def_tree(
            JR.cache_defs(jax_smoke(name), batch, max_seq))
    assert TR.param_count(cfg) == JR.param_count(jax_smoke(name))
    assert TR.param_count(configs.get_config(name)) == JR.param_count(
        jax_get_config(name))
    with pytest.raises(ValueError):
        decoder_layout(dataclasses.replace(cfg, family="diffusion"))


# ----------------------------------------------------------------- layers


def test_rmsnorm_rope_mlp_and_embedding_match_the_reference():
    x = _normal(0, 2, 5, 64)
    scale = 1.0 + _normal(1, 64)
    assert _max_abs(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
                    TL.rmsnorm({"scale": _t(scale)}, _t(x))) <= TOL
    h = _normal(2, 2, 7, 4, 16)
    for theta in (1e4, 1e6):
        assert _max_abs(JL.rope_freqs(16, theta),
                        TL.rope_freqs(16, theta)) <= TOL
        for pos in (np.arange(7), 300 + np.arange(7)):
            assert _max_abs(
                JL.apply_rope(jnp.asarray(h), jnp.asarray(pos), theta),
                TL.apply_rope(_t(h), torch.as_tensor(pos), theta)) <= TOL
    silu = {"wg": _normal(3, 64, 96) / 8, "wu": _normal(4, 64, 96) / 8,
            "wd": _normal(5, 96, 64) / 10}
    gelu = {"wi": _normal(6, 64, 96) / 8, "bi": _normal(7, 96),
            "wd": _normal(8, 96, 64) / 10, "bd": _normal(9, 64)}
    for p, act in ((silu, "silu"), (gelu, "gelu")):
        ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), act)
        ours = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), act)
        assert _max_abs(ref, ours) <= TOL
    table, unemb = _normal(10, 50, 64), _normal(11, 64, 50)
    ids = np.random.default_rng(12).integers(0, 50, (2, 5)).astype(np.int32)
    assert _max_abs(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids)),
                    TL.embed({"table": _t(table)}, torch.as_tensor(ids))) == 0
    for p in ({"table": table}, {"table": table, "unembed": unemb}):
        assert _max_abs(
            JL.unembed({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x)),
            TL.unembed({k: _t(v) for k, v in p.items()}, _t(x))) <= TOL


# -------------------------------------------------------------- attention


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["decoder"]["slot0"])


@pytest.mark.parametrize("name", DENSE)
def test_projections_match_the_reference(name):
    cfg = jax_smoke(name)
    params = pt.cast_floating(
        init_train_state(cfg, jax.random.PRNGKey(1))["params"], jnp.float32)
    ja = _layer0(params)["attn"]
    ta = {k: _t(v) for k, v in ja.items()}
    x = _normal(3, 2, 9, cfg.d_model)
    pos = np.arange(9) + 4
    assert _max_abs(JA.project_q(ja, jnp.asarray(x), cfg, jnp.asarray(pos)),
                    TA.project_q(ta, _t(x), cfg, torch.as_tensor(pos))) <= TOL
    for a, b in zip(JA.project_kv(ja, jnp.asarray(x), cfg, jnp.asarray(pos)),
                    TA.project_kv(ta, _t(x), cfg, torch.as_tensor(pos))):
        assert _max_abs(a, b) <= TOL
    o = _normal(4, 2, 9, cfg.num_heads, cfg.head_dim)
    assert _max_abs(JA.project_out(ja, jnp.asarray(o), cfg),
                    TA.project_out(ta, _t(o), cfg)) <= TOL


def test_quantize_kv_is_the_references_exactly():
    x = _normal(5, 2, 9, 3, 16) * 4
    x[0, 0, 0] = 0.0                         # a zero vector: the 1e-8 floor
    x[1, 2, 1, :4] = [1.5, -2.5, 0.5, 3.5]   # ties: round half to even
    x[1, 2, 1, 4] = 127.0
    jq, js = JA.quantize_kv(jnp.asarray(x))
    tq, ts = TA.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(
        np.asarray(JA.dequantize_kv(jq, js)),
        TA.dequantize_kv(tq, ts).numpy())


def test_int8_cache_round_trip_is_exact_and_writes_in_place():
    cfg = jax_smoke("qwen1.5-32b")
    B, T, K, D = 2, 12, cfg.num_kv_heads, cfg.head_dim
    jkv = {n: jnp.zeros((B, T, K) + ((D,) if n in "kv" else ()),
                        jnp.int8 if n in "kv" else jnp.float32)
           for n in ("k", "v", "k_scale", "v_scale")}
    tkv = {n: _t(a) for n, a in jkv.items()}
    for index, S in ((0, 5), (5, 1), (11, 3)):     # the last one clamps
        k, v = _normal(index, B, S, K, D), _normal(index + 1, B, S, K, D)
        jkv = JA.cache_update_tree(jkv, jnp.asarray(k), jnp.asarray(v),
                                   jnp.array(index, jnp.int32))
        same = TA.cache_update_tree(tkv, _t(k), _t(v), index)
        assert same is tkv
        for n in tkv:
            np.testing.assert_array_equal(np.asarray(jkv[n]), tkv[n].numpy())
    for a, b in zip(JA._materialize_kv(jkv), TA._materialize_kv(tkv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_cache_update_and_decode_attention_tree():
    B, T, K, D, H = 2, 10, 2, 16, 4
    ck = jnp.zeros((B, T, K, D), jnp.bfloat16)
    tk = torch.zeros((B, T, K, D), dtype=torch.bfloat16)
    k, v = _normal(6, B, 3, K, D), _normal(7, B, 3, K, D)
    jk, jv = JA.cache_update(ck, ck, jnp.asarray(k), jnp.asarray(v),
                             jnp.array(4, jnp.int32))
    kv = {"k": tk, "v": tk.clone()}
    TA.cache_update(kv["k"], kv["v"], _t(k), _t(v), 4)
    np.testing.assert_array_equal(_np(jk), kv["k"].float().numpy())
    np.testing.assert_array_equal(_np(jv), kv["v"].float().numpy())
    q = _normal(8, B, 1, H, D)
    ref = JA.decode_attention_tree(jnp.asarray(q), {"k": jk, "v": jv},
                                   jnp.array(6, jnp.int32))
    for backend in TA.BACKENDS:
        got = TA.decode_attention_tree(_t(q), kv, 6, backend=backend)
        assert _max_abs(ref, got) <= TOL


# ---------------------------------------------------------------- forward


def _params(name, seed, bf16=False):
    cfg = jax_smoke(name)
    params = init_train_state(cfg, jax.random.PRNGKey(seed))["params"]
    params = (cast_for_compute(params) if bf16
              else pt.cast_floating(params, jnp.float32))
    ours = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                            device="cpu")
    return cfg, params, ours


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
    """bf16 caches within one bf16 step plus ``tol``, the f32 bound of
    the values before the cast; int8 caches within one level (an f32
    value that straddles a rounding boundary); scales to f32 rounding."""
    for n, a in jcache["slot0"]["kv"].items():
        a, b = _np(a), tcache["slot0"]["kv"][n].float().numpy()
        if n.endswith("scale"):
            assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())
        elif tcache["slot0"]["kv"][n].dtype == torch.int8:
            assert np.abs(a - b).max() <= 1
        else:
            assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + tol).all()


@pytest.mark.parametrize("name", DENSE)
def test_forward_f32_matches_the_reference_in_every_mode(name, monkeypatch):
    cfg, params, ours = _params(name, 0)
    B, S = 2, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    toks = toks.astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)

    # train
    ref, self_diff = _reference_self_difference(params, cfg, jt, monkeypatch)
    bound = 1e-4 + 8 * self_diff
    for backend in ("cuda", "interpret"):
        got = forward(ours, cfg, tokens=tt, mode="train", backend=backend)[0]
        assert got.shape == (B, S, cfg.vocab_size)
        assert _max_abs(ref, got) <= bound, (self_diff, bound)

    # prefill: the last position's logits and the cache
    jcache = jax_init_cache(cfg, B, S + 4)
    ref, jcache = JT.forward(params, cfg, tokens=jt, mode="prefill",
                             caches=jcache, logits_slice_last=True)[:2]
    tcache = init_cache(cfg, B, S + 4, device="cpu")
    got, out_cache, aux = forward(ours, cfg, tokens=tt, mode="prefill",
                                  caches=tcache, logits_slice_last=True)
    assert out_cache is tcache and aux == {}
    assert got.shape == (B, 1, cfg.vocab_size)
    assert _max_abs(ref, got) <= bound
    _assert_caches_close(jcache, tcache, bound)

    # decode from the reference's own cache, so only the step differs
    nxt = np.asarray(jnp.argmax(ref[:, -1], -1), np.int32)[:, None]
    ref, jcache2 = JT.forward(params, cfg, tokens=jnp.asarray(nxt),
                              mode="decode", index=jnp.array(S, jnp.int32),
                              caches=jcache, logits_slice_last=True)[:2]
    for backend in ("cuda", "interpret"):
        tcache = _cache_to_torch(jcache)
        got = forward(ours, cfg, tokens=torch.as_tensor(nxt), mode="decode",
                      index=S, caches=tcache, logits_slice_last=True,
                      backend=backend)[0]
        assert _max_abs(ref, got) <= bound
        _assert_caches_close(jcache2, tcache, bound)


@pytest.mark.parametrize("name", DENSE)
def test_forward_bf16_matches_under_the_margin_rule(name, record_property):
    """The port's bf16 logits against the reference as it runs (jitted)
    and evaluated op by op (``jax.disable_jit``), which rounds every bf16
    op as the port's eager ops do.  Against the op-by-op evaluation the
    bounds are ``tol``; against the jitted one ``tol`` plus the
    reference's own distance between its two evaluations, measured here
    (``lax.scan``'s body through XLA keeps f32 between fused ops: up to
    1.32 on Qwen2-7B's smoke config)."""
    cfg, params, ours = _params(name, 0, bf16=True)
    tol = 0.02 if cfg.use_qk_norm else 1.0
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    jt = jnp.asarray(toks)
    jitted = _np(JT.forward(params, cfg, tokens=jt, mode="train")[0])
    with jax.disable_jit():
        op_by_op = _np(JT.forward(params, cfg, tokens=jt, mode="train")[0])
    spread = float(np.abs(jitted - op_by_op).max())
    got = forward(ours, cfg, tokens=torch.as_tensor(toks), mode="train")[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for what, ref, allow in (("op by op", op_by_op, tol),
                             ("jitted", jitted, tol + spread)):
        row = np.abs(ref - got).max(-1)
        assert row.max() <= allow and np.median(row) <= 0.1, (what, row)
        top = np.sort(ref, -1)
        margin = top[..., -1] - top[..., -2]
        differ = ref.argmax(-1) != got.argmax(-1)
        assert (margin[differ] <= allow).all(), what
        inside = int((margin <= allow).sum())
        record_property(f"rows_inside_margin_{what.replace(' ', '_')}",
                        inside)
        print(f"{name} against the {what} reference: max {row.max()}, "
              f"median {np.median(row)}, {int(differ.sum())} greedy tokens "
              f"differ, {inside} of {margin.size} rows inside the {allow} "
              f"margin (the reference's own spread {spread})")


@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_decode_through_cache_matches_teacher_forcing(backend):
    """The reference's cache invariant (tests/test_train_serve.py) on the
    port: greedy decode through the KV cache reproduces the argmax chain
    of full teacher-forced forwards."""
    cfg = jax_smoke("qwen3-1.7b")
    params = init_train_state(cfg, jax.random.PRNGKey(7))["params"]
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    B, S, N = 2, 16, 6
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
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


# --------------------------------------------------------------- registry


@pytest.mark.parametrize("name", DENSE)
def test_shapes_counts_and_init_follow_the_reference(name):
    cfg = configs.get_smoke_config(name)
    jdefs = JR.param_defs(jax_smoke(name))
    g = torch.Generator().manual_seed(0)
    params = TR.init_params(cfg, generator=g, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    for path, d in jax.tree_util.tree_flatten_with_path(
            jdefs, is_leaf=pt.is_def)[0]:
        keys = [p.key for p in path]
        if keys[0] == "decoder":
            t, shape = params["layers"][1], d.shape[1:]
            for k in keys[2:]:
                t = t[k]
        else:
            t, shape = params, d.shape
            for k in keys:
                t = t[k]
        assert tuple(t.shape) == tuple(shape), keys
        want = torch.bfloat16 if len(shape) >= 2 else torch.float32
        assert t.dtype == want, keys
        if d.init == "ones":
            assert torch.equal(t, torch.ones_like(t))
        elif d.init == "zeros":
            assert not t.any()
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            std = 0.02 if d.init == "normal" else fan_in ** -0.5
            assert abs(t.float().std().item() / std - 1) < 0.1, keys
    again = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["layers"][2]["attn"]["wq"],
                       params["layers"][2]["attn"]["wq"])
    jc = JR.cache_defs(jax_smoke(name), 3, 20)["slot0"]["kv"]
    tc = TR.cache_defs(cfg, 3, 20)["slot0"]["kv"]
    assert {n: (tuple(d.shape), jnp.dtype(d.dtype).name)
            for n, d in jc.items()} == {
        n: (d.shape, str(d.dtype).split(".")[-1]) for n, d in tc.items()}


def test_conversion_is_a_copy_and_layers_view_the_stack():
    cfg, params, ours = _params("qwen2-7b", 3, bf16=True)
    slot = params["decoder"]["slot0"]
    for l, layer in enumerate(ours["layers"]):
        ref = np.asarray(slot["attn"]["wq"][l])
        got = layer["attn"]["wq"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(ref.view(np.uint16),
                                      got.view(torch.int16).numpy().view(
                                          np.uint16))
        assert got.untyped_storage().data_ptr() == ours["layers"][0][
            "attn"]["wq"].untyped_storage().data_ptr()
    np.testing.assert_array_equal(np.asarray(params["final_norm"]["scale"]),
                                  ours["final_norm"]["scale"].numpy())
