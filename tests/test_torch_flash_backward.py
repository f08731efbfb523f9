"""K7b's plain version (``attention_bwd_ref``, the arithmetic of the
backward kernels; with ``split_p`` that of its bf16 kernels) and
``FlashAttentionFn`` on CPU tensors against
autograd's gradient of ``attention_ref`` and against ``jax.vjp`` of the
reference's ``attention_ref`` and ``chunked_attention``; the refusals of
K8's TPU interface and K9 under autograd, and the discretizing entry's
gradient on CPU tensors.

Tolerances: f32 within 1e-5 of the largest gradient of each of dq, dk and
dv (the same f32 math summed in another order); bf16 within 8e-3 of it
(``chip_smoke.K7_TOL``: the gradients are rounded once to bf16, and two
f32 results that straddle a rounding boundary land one bf16 step
apart)."""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.models.attention import chunked_attention
from repro_torch.kernels import _ext
from repro_torch.kernels.binarized_gemm import binarized_gemm
from repro_torch.kernels.binarized_gemm.ops import binarized_gemm_launch
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    attention_bwd_ref,
    attention_ref,
    first_masked_row,
    flash_attention,
    flash_attention_bwd_launch,
)
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_discretized,
)
from repro_torch.kernels.selective_scan.ops import (
    selective_scan_discretized_launch,
    selective_scan_launch,
)

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# name, B, Sq, Skv, H, K, D, causal, window, q_offset, skv (None: Skv)
CASES = (
    ("smoke_group", 2, 37, 37, 4, 2, 16, True, 0, 0, None),
    ("qwen3_group", 1, 70, 70, 16, 8, 128, True, 0, 0, None),
    ("window", 2, 100, 100, 4, 2, 32, True, 16, 0, None),
    ("cross", 2, 40, 90, 4, 2, 16, False, 0, 0, 77),
    ("encoder_ragged", 1, 65, 65, 4, 4, 64, False, 0, 0, None),
    ("fully_masked_rows", 1, 20, 50, 4, 2, 16, True, 8, 40, 45),
)


def _inputs(seed, B, Sq, Skv, H, K, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D),
                  (B, Sq, H, D)))


def _autograd(q, k, v, do, skv, **kw):
    """autograd's gradient of attention_ref over the first skv keys."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attention_ref(q, k[:, :skv], v[:, :skv], **kw).backward(do)
    return q.grad, k.grad, v.grad


def _close(got, want, dtype, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        g, w = np.asarray(torch.as_tensor(g).float()), np.asarray(
            torch.as_tensor(w).float())
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= TOL[dtype] * scale, (what, name, err, scale)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd(case, dtype):
    _, B, Sq, Skv, H, K, D, causal, window, q_offset, skv = case
    skv = Skv if skv is None else skv
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(1, B, Sq, Skv, H, K, D))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = attention_bwd_ref(q, k, v, do, skv=skv, **kw)
    _close(got, _autograd(q, k, v, do, skv, **kw), dtype, case[0])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_vjp(case):
    """Against jax.vjp of the reference's attention_ref and of
    chunked_attention (the function the JAX package trains through), in
    f32; keys past skv are cut before the call, as the port's forward
    cuts them.  A fully masked row is attention_ref's (a softmax uniform
    over the keys); chunked_attention's differs there, so it is held on
    the other cases."""
    _, B, Sq, Skv, H, K, D, causal, window, q_offset, skv = case
    skv = Skv if skv is None else skv
    q, k, v, do = _inputs(2, B, Sq, Skv, H, K, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)), skv=skv,
                            **kw)
    fns = [lambda a, b, c: jax_attention_ref(a, b, c, **kw)]
    if first_masked_row(Sq, skv, window=window, q_offset=q_offset) == Sq:
        fns.append(lambda a, b, c: chunked_attention(a, b, c, kv_chunk=32,
                                                     **kw))
    for fn in fns:
        vjp = jax.jit(lambda a, b, c, g: jax.vjp(fn, a, b, c)[1](g))
        dq, dk, dv = (np.array(x) for x in vjp(
            q, k[:, :skv], v[:, :skv], do))
        pad = np.zeros((B, Skv - skv, K, D), np.float32)
        want = (dq, np.concatenate([dk, pad], 1),
                np.concatenate([dv, pad], 1))
        _close(got, tuple(map(torch.from_numpy, want)), torch.float32,
               case[0])


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_matches_plain_autograd_and_jax(case, dtype):
    """``attention_bwd_ref(split_p=True)``, the plain form of the bf16
    kernels' schedule (P and dS as bf16 hi + lo in O += P V, dV, dK and
    dQ), against ``attention_bwd_ref``, autograd's gradient of
    ``attention_ref`` and ``jax.vjp`` of the reference's
    ``attention_ref``, all on the same dtype-rounded inputs, within
    ``TOL`` (the split keeps about 2^-16 of P and dS)."""
    _, B, Sq, Skv, H, K, D, causal, window, q_offset, skv = case
    skv = Skv if skv is None else skv
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(6, B, Sq, Skv, H, K, D))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = attention_bwd_ref(q, k, v, do, skv=skv, split_p=True, **kw)
    _close(got, attention_bwd_ref(q, k, v, do, skv=skv, **kw), dtype,
           case[0])
    _close(got, _autograd(q, k, v, do, skv, **kw), dtype, case[0])
    qn, kn, vn, don = (t.float().numpy() for t in (q, k, v, do))
    vjp = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda x, y, z: jax_attention_ref(x, y, z, **kw), a, b, c)[1](g))
    dq, dk, dv = (np.array(x) for x in vjp(qn, kn[:, :skv], vn[:, :skv],
                                             don))
    pad = np.zeros((B, Skv - skv, K, D), np.float32)
    want = (dq, np.concatenate([dk, pad], 1), np.concatenate([dv, pad], 1))
    _close(got, tuple(torch.from_numpy(w).to(dtype) for w in want), dtype,
           case[0])


def test_fully_masked_rows_are_the_window_past_skv():
    assert first_masked_row(20, 45, window=8, q_offset=40) == 12
    assert first_masked_row(20, 45, window=0, q_offset=40) == 20
    assert first_masked_row(20, 45, window=8, q_offset=0) == 20
    assert first_masked_row(20, 5, window=1, q_offset=10) == 0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_function_on_cpu_tensors_gives_the_plain_gradients(dtype):
    """Under autograd ``flash_attention`` runs FlashAttentionFn: the plain
    forward and ``attention_bwd_ref``, no extension, no counted launch;
    without grad it builds no graph."""
    B, Sq, Skv, H, K, D = 2, 33, 50, 4, 2, 16
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(3, B, Sq, Skv, H, K, D))
    kw = dict(causal=False, window=0, q_offset=0)
    before = dict(_ext.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, skv=40, **kw)
    assert type(out.grad_fn) is FlashAttentionFn._backward_cls
    assert torch.equal(out.detach(), attention_ref(q, k[:, :40], v[:, :40],
                                                   **kw))
    out.backward(do)
    want = attention_bwd_ref(q, k, v, do, skv=40, **kw)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    _close([t.grad for t in leaves], _autograd(q, k, v, do, 40, **kw), dtype,
           "function")
    with torch.no_grad():
        assert flash_attention(*leaves, skv=40, **kw).grad_fn is None
    assert flash_attention(q, k, v, skv=40, **kw).grad_fn is None
    assert _ext.LAUNCHES == before


def test_backward_launch_wrapper_takes_cuda_tensors_only():
    q, k, v, do = map(torch.from_numpy, _inputs(4, 1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_launch(q, k, v, do, causal=True, window=0,
                                   q_offset=0, skv=8)
    with pytest.raises(ValueError, match="dO"):
        flash_attention_bwd_launch(q, k, v, do[:, :4], causal=True,
                                   window=0, q_offset=0, skv=8)


def test_scan_and_bgemm_refuse_autograd_on_the_card_path():
    """K8's TPU-interface wrapper and K9's raise under autograd (their
    outputs would carry no gradient, and no path of either package trains
    through them) before they look at the device; so does the discretizing
    entry's bare launch, whose gradient is SelectiveScanFn's (K8b).  The
    CPU plain versions stay differentiable."""
    rng = np.random.default_rng(5)
    B, S, di, N = 1, 4, 8, 4
    dA = torch.from_numpy(rng.uniform(0.5, 1, (B, S, di, N)).astype(
        np.float32)).requires_grad_()
    dBx = torch.from_numpy(rng.normal(size=(B, S, di, N)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    h0 = torch.zeros(B, di, N)
    with pytest.raises(NotImplementedError, match="no path"):
        selective_scan_launch(dA, dBx, C, h0)
    dt = torch.ones(B, S, di, requires_grad=True)
    with pytest.raises(NotImplementedError, match="selective_scan_disc"):
        selective_scan_discretized_launch(dt, torch.ones(di, N), C, C,
                                          torch.ones(B, S, di), h0)
    x = torch.randn(3, 40, requires_grad=True)
    with pytest.raises(NotImplementedError, match="binarized_gemm"):
        binarized_gemm_launch(x, torch.randn(40, 5))
    y, _ = selective_scan(dA, dBx, C, h0)
    y.sum().backward()
    assert dA.grad is not None and bool(torch.isfinite(dA.grad).all())
    with torch.no_grad():
        binarized_gemm(x, torch.randn(40, 5))


def test_discretized_entry_gives_a_gradient_on_cpu():
    """The discretizing entry no longer refuses autograd: on CPU tensors
    it runs SelectiveScanFn (the plain forward and ``selective_scan_bwd
    _ref``) and every input gets a finite gradient, launching nothing."""
    rng = np.random.default_rng(6)
    B, S, di, N = 1, 4, 8, 4
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).requires_grad_()
    dt = torch.nn.functional.softplus(f(B, S, di))
    A, Bm, Cm, x, h0 = -f(di, N).exp(), f(B, S, N), f(B, S, N), f(B, S, di), \
        f(B, di, N)
    before = dict(_ext.LAUNCHES)
    y, h = selective_scan_discretized(dt, A, Bm, Cm, x, h0)
    leaves = (dt, A, Bm, Cm, x, h0)
    grads = torch.autograd.grad(y.sum() + h.sum(), leaves)
    assert all(g.shape == t.shape and bool(torch.isfinite(g).all())
               for g, t in zip(grads, leaves))
    assert _ext.LAUNCHES == before


def _attention_f64(q, k, v, *, causal):
    """attention_ref's function in f64 (the exact yardstick)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, Sq, K, H // K, D), k)
    s = s / np.sqrt(D)
    if causal:
        mask = torch.arange(k.shape[1])[None, :] <= torch.arange(Sq)[:, None]
        s = torch.where(mask, s, -1e300)
    o = torch.einsum("bkgst,btkd->bkgsd", torch.softmax(s, -1), v)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def test_f32_dq_at_large_scores_is_f32s_own_error(record_property):
    """Jamba's large-score case (``chip_smoke.K7B_LARGE_SCORES``: q x 60,
    D = 128, S = 512, causal, scores spreading near 360 over a row) at
    B = 1 and 8 query heads over 1.  On the card every f32 evaluation of
    dq lies about 5e-5 of its largest value from the f64 gradient.  Here
    the reference's own f32 ``jax.vjp`` of ``chunked_attention`` lies as
    far from it as the port's ``attention_bwd_ref`` (at least 1 / 1.5 of
    its distance): the distance is f32's, not the port's."""
    B, S, H, K, D = 1, 512, 8, 1, 128
    q, k, v, do = _inputs(7, B, S, S, H, K, D)
    q = q * np.float32(60.0)
    exact = [t.detach().clone().double().requires_grad_()
             for t in map(torch.from_numpy, (q, k, v))]
    _attention_f64(*exact, causal=True).backward(
        torch.from_numpy(do).double())
    dq64 = exact[0].grad.numpy()
    port = attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)),
                             causal=True, window=0, q_offset=0,
                             skv=S)[0].numpy()
    vjp = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda x, y, z: chunked_attention(x, y, z, causal=True), a, b, c
    )[1](g))
    ref = np.asarray(vjp(q, k, v, do)[0])
    scale = np.abs(dq64).max()
    port_err = float(np.abs(port - dq64).max() / scale)
    ref_err = float(np.abs(ref - dq64).max() / scale)
    record_property("dq_port_from_f64", port_err)
    record_property("dq_reference_from_f64", ref_err)
    print(f"dq from the f64 gradient, of its largest value: port "
          f"{port_err:.3e}, reference {ref_err:.3e}")
    assert ref_err >= port_err / 1.5, (port_err, ref_err)
    assert port_err < 1e-3
