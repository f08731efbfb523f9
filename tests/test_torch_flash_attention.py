"""K7's plain version and ``flash_attention`` on CPU tensors against the
reference: ``attention_ref``, the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it), ``chunked_attention`` and
``decode_attention``.

Tolerance: f32 max abs 1e-5 (the two frameworks sum the products in
different orders; outputs are of order 1).  bf16 outputs may differ by
one bf16 step (2^-7 of the value) where the f32 results straddle a
rounding boundary."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import chunked_attention, decode_attention
from repro_torch.kernels.flash_attention import (
    DECODE_MAX_SQ,
    attention_ref,
    attention_split_ref,
    decode_plan,
    flash_attention,
    flash_attention_launch,
    live_keys,
)
from repro_torch.models import attention as tattn

TOL = 1e-5
# D, G, causal, window, q_offset: every combination the slice's shapes use
CASES = list(itertools.product((16, 32), (1, 2, 4), (True, False), (0, 8),
                               (0, 5)))


def _inputs(seed, B, Sq, Skv, H, K, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))


def _shape(i, q_offset):
    """Alternate a ragged and a full tile; keys cover every query
    position, so every row has a key to attend."""
    B, Sq = ((2, 37), (1, 64))[i % 2]
    return B, Sq, Sq + q_offset


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("i,case", list(enumerate(CASES)),
                         ids=[f"D{d}-G{g}-c{int(c)}-w{w}-o{o}"
                              for d, g, c, w, o in CASES])
def test_plain_and_op_match_reference(i, case):
    D, G, causal, window, q_offset = case
    B, Sq, Skv = _shape(i, q_offset)
    K = 2
    q, k, v = _inputs(i, B, Sq, Skv, K * G, K, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    chunked = chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_chunk=16, **kw)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    plain = attention_ref(tq, tk, tv, **kw)
    op = flash_attention(tq, tk, tv, **kw)
    for got in (plain, op):
        assert got.shape == (B, Sq, K * G, D) and got.dtype == torch.float32
        assert _max_abs(got, ref) <= TOL
        assert _max_abs(got, chunked) <= TOL


@pytest.mark.parametrize("D,G,causal,window,q_offset", [
    (16, 1, True, 0, 0), (16, 2, True, 8, 5), (16, 4, False, 8, 0),
    (16, 2, False, 0, 5), (32, 1, False, 8, 5), (32, 2, True, 0, 5),
    (32, 4, True, 8, 0), (32, 4, False, 0, 0)])
def test_op_matches_pallas_kernel_in_interpret_mode(D, G, causal, window,
                                                    q_offset):
    B, Sq = 2, 37
    q, k, v = _inputs(D + G, B, Sq, Sq + q_offset, 2 * G, 2, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    kernel = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=16, block_k=16, interpret=True, **kw)
    op = flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    assert _max_abs(op, kernel) <= TOL


@pytest.mark.parametrize("G", (1, 2, 4))
@pytest.mark.parametrize("index", (0, 17, 39))
def test_decode_step_matches_decode_attention(G, index):
    """One query at ``index`` against a 40-slot cache: K7's call with
    causal masking, q_offset = index and skv = T is decode_attention's
    ``slot <= index`` mask."""
    B, T, K, D = 2, 40, 2, 16
    q, k, v = _inputs(index + G, B, 1, T, K * G, K, D)
    ref = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.array(index, jnp.int32))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    op = flash_attention(tq, tk, tv, causal=True, q_offset=index, skv=T)
    assert _max_abs(op, ref) <= TOL
    assert _max_abs(tattn.decode_attention(tq, tk, tv, index), ref) <= TOL


def test_skv_masks_the_keys_past_it():
    q, k, v = map(torch.as_tensor, _inputs(3, 2, 9, 30, 4, 2, 16))
    for causal, q_offset in ((False, 0), (True, 20)):
        kw = dict(causal=causal, q_offset=q_offset)
        full = flash_attention(q, k[:, :25], v[:, :25], **kw)
        assert torch.equal(flash_attention(q, k, v, skv=25, **kw), full)
        ref = jax_attention_ref(jnp.asarray(q.numpy()),
                                jnp.asarray(k[:, :25].numpy()),
                                jnp.asarray(v[:, :25].numpy()), **kw)
        assert _max_abs(full, ref) <= TOL


def test_bf16_inputs_compute_in_f32_and_round_once():
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16))
               for a in _inputs(5, 2, 37, 42, 8, 2, 32))
    kw = dict(causal=True, window=8, q_offset=5)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw), np.float32)

    def bf16(a):
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)

    op = flash_attention(bf16(q), bf16(k), bf16(v), **kw)
    assert op.dtype == torch.bfloat16
    diff = np.abs(op.float().numpy() - ref)
    assert (diff <= 2.0 ** -7 * np.abs(ref) + 1e-6).all(), diff.max()
    assert (diff == 0).mean() > 0.9


@pytest.mark.parametrize("bad,match", [
    (dict(D=48), "head width"), (dict(K=4), "group"),
    (dict(skv=0), "skv"), (dict(skv=11), "skv"),
    (dict(q_offset=-1), "q_offset"), (dict(kshape=True), "shape")])
def test_op_refuses_what_the_kernel_does_not_take(bad, match):
    D, K = bad.get("D", 16), bad.get("K", 2)
    q = torch.zeros(1, 4, 6, D)
    k = torch.zeros(1, 10, K, D)
    v = k[:, :9] if bad.get("kshape") else k
    kw = {n: bad[n] for n in ("skv", "q_offset") if n in bad}
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, **kw)


def test_launch_wrapper_takes_cuda_tensors_only():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_launch(q, q, q, causal=True, window=0, q_offset=0,
                               skv=4)


# ------------------------------------------------ the kernels' arithmetic
#
# ``attention_split_ref`` is the plain form of K7's kernels: the split-KV
# decode, bf16 or f32 (the wrapper's chunks of the live keys, 32-key
# tiles, partial (m, l, acc) merged with the TPU kernel's alpha), the
# bf16 prefill (64-key tiles, P V as p_hi V + p_lo V on the tensor cores)
# and the f32 prefill (64-key tiles, P V in f32).
# Tolerance: f32 inputs within TOL of the reference (the same f32 math in
# another order; the split P costs about 2^-16 of p); bf16 inputs within
# K7_BF16_TOL * max(1, |ref|), chip_smoke.K7_TOL's rule: both compute in
# f32 from the same bf16 inputs and round once, so two results that
# straddle a rounding boundary land one bf16 step apart.

K7_BF16_TOL = 8e-3
N_SM = 132                                  # the H100's SMs


def _split_decode(q, k, v, *, causal, window, q_offset, skv=None):
    B, Sq, H, _ = q.shape
    K = k.shape[2]
    skv = k.shape[1] if skv is None else skv
    lo, hi, chunk, _ = decode_plan(B, Sq, H, K, skv, causal=causal,
                                   window=window, q_offset=q_offset,
                                   n_sm=N_SM)
    return attention_split_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, lo=lo, hi=hi, chunk=chunk,
                               tile=32)


# D, G, Sq, Skv, q_offset, window, chunk: chunk edges that cut the live
# keys, q_offset at a chunk's first key (64) and last (63, 95), the last
# key of the cache, a window in decode, Sq up to DECODE_MAX_SQ
SPLIT_CASES = [
    (16, 1, 1, 130, 63, 0, None), (16, 2, 1, 130, 64, 0, None),
    (32, 8, 1, 200, 95, 0, None), (32, 12, 1, 200, 199, 0, None),
    (64, 2, 1, 300, 0, 0, None), (64, 8, 2, 300, 150, 40, None),
    (128, 12, 4, 160, 120, 0, None), (128, 8, 1, 200, 150, 37, None),
    (128, 2, 3, 256, 100, 0, 7), (16, 12, 4, 70, 40, 9, 5),
    (32, 1, 2, 90, 31, 16, 32), (64, 12, 1, 128, 127, 0, 32)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"D{c[0]}-G{c[1]}-Sq{c[2]}-o{c[4]}-w{c[5]}"
                              f"-c{c[6]}" for c in SPLIT_CASES])
def test_split_decode_arithmetic_matches_reference(case):
    """The split-KV decode's chunks and combine, f32 inputs, against the
    JAX ``attention_ref`` and the Pallas kernel in interpret mode."""
    D, G, Sq, Skv, q_offset, window, chunk = case
    B, K = 2, 2
    q, k, v = _inputs(D * G + Sq, B, Sq, Skv, K * G, K, D)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    kernel = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=8,
                       block_k=16, interpret=True, **kw)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    if chunk is None:
        got = _split_decode(tq, tk, tv, **kw)
    else:
        lo, hi = live_keys(Sq, Skv, **kw)
        got = attention_split_ref(tq, tk, tv, lo=lo, hi=hi, chunk=chunk,
                                  tile=32, **kw)
    assert got.shape == (B, Sq, K * G, D) and got.dtype == torch.float32
    assert _max_abs(got, ref) <= TOL
    assert _max_abs(got, kernel) <= TOL


@pytest.mark.parametrize("D", (16, 32, 64, 128))
@pytest.mark.parametrize("G", (1, 2, 8, 12))
def test_split_prefill_arithmetic_matches_reference(D, G):
    """The prefill's 64-key tiles with P split into bf16 hi and lo, ragged
    rows and keys, causal with a window, f32 inputs."""
    B, K, Sq = 1, 2, 70
    kw = dict(causal=True, window=50, q_offset=9)
    q, k, v = _inputs(D + G, B, Sq, Sq + 9, K * G, K, D)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention_split_ref(*map(torch.as_tensor, (q, k, v)), tile=64,
                              split_p=True, **kw)
    assert _max_abs(got, ref) <= TOL


# K7's f32 kernels: the same split-KV decode plan (an f32 call takes it
# for Sq <= DECODE_MAX_SQ as a bf16 one does) and the f32 prefill's
# 64-key tiles with P in f32 (no hi/lo split: P V on the CUDA cores)


@pytest.mark.parametrize("q_offset", (0, 31, 32, 63, 64, 255, 543, 1023))
@pytest.mark.parametrize("G", (2, 8))
def test_split_decode_f32_plan_matches_reference(G, q_offset):
    """The f32 decode at the Qwen3 (G = 2) and Jamba (G = 8) groups, D =
    128, 1,024 cached keys: the wrapper's plan and 32-key tiles, f32 in
    and out, within TOL of the JAX ``attention_ref``."""
    B, K, D, Skv = 1, 2, 128, 1024
    q, k, v = _inputs(G * 7 + q_offset, B, 1, Skv, K * G, K, D)
    kw = dict(causal=True, window=0, q_offset=q_offset)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    got = _split_decode(*map(torch.as_tensor, (q, k, v)), **kw)
    assert got.shape == (B, 1, K * G, D) and got.dtype == torch.float32
    assert _max_abs(got, ref) <= TOL


@pytest.mark.parametrize("D", (16, 32, 64, 128))
@pytest.mark.parametrize("G", (1, 2, 8, 12))
def test_split_prefill_f32_arithmetic_matches_reference(D, G):
    """The f32 prefill's 64-key tiles, P kept in f32, ragged rows and
    keys, causal with a window, against the JAX ``attention_ref`` and the
    Pallas kernel in interpret mode."""
    B, K, Sq = 1, 2, 70
    kw = dict(causal=True, window=50, q_offset=9)
    q, k, v = _inputs(D * 3 + G, B, Sq, Sq + 9, K * G, K, D)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    kernel = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=16,
                       block_k=16, interpret=True, **kw)
    got = attention_split_ref(*map(torch.as_tensor, (q, k, v)), tile=64,
                              split_p=False, **kw)
    assert got.dtype == torch.float32
    assert _max_abs(got, ref) <= TOL
    assert _max_abs(got, kernel) <= TOL


def _bf16(a):
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("Sq,q_offset,window", [(1, 0, 0), (1, 63, 0),
                                                (1, 64, 0), (1, 255, 0),
                                                (1, 200, 64), (4, 100, 0),
                                                (70, 0, 0), (70, 30, 24)])
def test_split_arithmetic_in_bf16_rounds_once(Sq, q_offset, window):
    """bf16 inputs at the Qwen3 head width, G = 8: decode (the wrapper's
    plan) and prefill (split P) within K7's bf16 rule of the reference's
    f32 math on the same inputs."""
    B, K, G, D, Skv = 1, 2, 8, 128, 256
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in
               _inputs(Sq + q_offset, B, Sq, Skv, K * G, K, D))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ref = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw),
                     np.float32)
    tq, tk, tv = map(_bf16, (q, k, v))
    if Sq <= DECODE_MAX_SQ:
        got = _split_decode(tq, tk, tv, **kw)
    else:
        got = attention_split_ref(tq, tk, tv, tile=64, split_p=True, **kw)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= K7_BF16_TOL * np.maximum(np.abs(ref), 1.0)).all(), \
        diff.max()


def test_decode_plan_covers_the_live_keys_only():
    """Chunks are whole 32-key tiles over [lo, hi), the causal and window
    limits of the call's rows, and fill the card's SMs; with no live key
    every key is taken (all masked: the softmax's uniform average)."""
    from repro_torch.kernels.flash_attention.ops import DECODE_BLOCKS_PER_SM

    per_sm = DECODE_BLOCKS_PER_SM
    for B, Sq, H, K, skv, window, q_offset in [
            (4, 1, 16, 8, 1024, 0, 511), (4, 1, 16, 8, 1024, 0, 1023),
            (4, 1, 64, 8, 1024, 0, 543), (4, 1, 16, 8, 1024, 100, 700),
            (1, 4, 96, 1, 300, 0, 10), (2, 1, 4, 2, 40, 0, 0)]:
        lo, hi, chunk, n = decode_plan(B, Sq, H, K, skv, causal=True,
                                       window=window, q_offset=q_offset,
                                       n_sm=N_SM)
        assert hi == min(skv, q_offset + Sq)
        assert lo == (max(q_offset - window + 1, 0) if window else 0)
        assert chunk % 32 == 0 and (n - 1) * chunk < hi - lo <= n * chunk
        rows = -(-Sq * (H // K) // 64)
        assert n == 1 or B * K * rows * (n - 1) < per_sm * N_SM
    assert decode_plan(4, 1, 16, 8, 1024, causal=True, window=0,
                       q_offset=63, n_sm=N_SM)[2:] == (32, 2)
    assert live_keys(1, 10, causal=True, window=4, q_offset=40) == (0, 10)
    q, k, v = map(torch.as_tensor, _inputs(9, 1, 1, 10, 2, 1, 16))
    kw = dict(causal=True, window=4, q_offset=40)
    assert _max_abs(_split_decode(q, k, v, **kw),
                    attention_ref(q, k, v, **kw)) <= TOL


def test_cpu_op_runs_attention_ref_and_nothing_else(monkeypatch):
    """On CPU tensors the op is ``attention_ref``: no plan, no split, no
    extension, no counted launch."""
    from repro_torch.kernels import _ext
    from repro_torch.kernels.flash_attention import ops

    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return attention_ref(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("not on the CPU")

    monkeypatch.setattr(ops, "attention_ref", counted)
    monkeypatch.setattr(ops, "decode_plan", refuse)
    monkeypatch.setattr(_ext, "extension", refuse)
    before = dict(_ext.LAUNCHES)
    for Sq, q_offset in ((1, 20), (30, 0)):
        q, k, v = map(torch.as_tensor, _inputs(Sq, 2, Sq, 40, 8, 2, 32))
        kw = dict(causal=True, window=0, q_offset=q_offset)
        got = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              skv=32, **kw)
        assert torch.equal(got, attention_ref(
            q.bfloat16(), k[:, :32].bfloat16(), v[:, :32].bfloat16(), **kw))
    assert len(calls) == 2 and _ext.LAUNCHES == before

