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
    attention_ref,
    flash_attention,
    flash_attention_launch,
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
