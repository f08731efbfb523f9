"""K8's plain version and op (``repro_torch.kernels.selective_scan``)
against the reference's oracle (``selective_scan_ref``, the sequential
recurrence) and its chunked associative scan (``_ssm_scan_chunked``, what
its Mamba block serves), on CPU tensors.  The reference's Pallas kernel
is not a reference here: it fails on this jax (ROADMAP Queue 3).

Tolerances.  XLA on the CPU contracts ``dA * h + dBx`` into a fused
multiply-add; the plain version (as K8) rounds the product and the sum
apart, so h differs by about an ulp per step.  h is held within 1e-6 x
(1 + |h|); y, a sum of N products that may cancel, within 1e-6 x (1 +
sum_n |h_t[n] C_t[n]|), the size of the terms it sums (the port's h).
Against the chunked scan, whose cumulative products and sums run in
another order, the bound is 1e-5 of the same scales.

The discretizing entry (``selective_scan_discretized``) is held the same
way against the reference's own expressions (``repro/models/ssm.py:117-
121`` in jnp on the same numpy inputs, x in f32 or bf16) followed by its
oracle; the two frameworks' exp may differ by an ulp, within the same
bounds.  ``selective_scan_channel_ref``, K8's own order written out (y
summed over n in ascending order, every product and sum rounded apart),
is held to the oracle under the same bounds and to the plain version's h
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import (
    selective_scan_ref as jax_scan_ref,
)
from repro.models.ssm import _ssm_scan_chunked
from repro_torch.kernels.selective_scan import (
    STATE_WIDTHS,
    discretize,
    selective_scan,
    selective_scan_channel_ref,
    selective_scan_discretized,
    selective_scan_discretized_launch,
    selective_scan_discretized_ref,
    selective_scan_launch,
    selective_scan_ref,
)


def _inputs(seed, B, S, di, N, realistic=False):
    rng = np.random.default_rng(seed)
    if realistic:
        # dA = exp(dt * A): dt = softplus(N(0, 1)), A = -(1..N)
        dt = np.log1p(np.exp(rng.normal(size=(B, S, di, 1))))
        dA = np.exp(dt * -np.arange(1, N + 1))
    else:
        dA = np.exp(-rng.uniform(0.0, 2.0, (B, S, di, N)))
    dBx = rng.normal(size=(B, S, di, N))
    C = rng.normal(size=(B, S, N))
    h0 = rng.normal(size=(B, di, N))
    return tuple(a.astype(np.float32) for a in (dA, dBx, C, h0))


def _term_scale(h_steps, C):
    """sum_n |h_t[n] C_t[n]| per (b, t, d)."""
    return (h_steps.abs() * C.abs()[:, :, None, :]).sum(-1)


def _h_steps(dA, dBx, h0):
    h, out = h0, []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        out.append(h)
    return torch.stack(out, 1)


def _assert_close(ref, got, scale, tol):
    ref = torch.from_numpy(np.array(ref))
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = (got - ref).abs()
    assert bool((err <= tol * (1 + scale)).all()), float(err.max())


CASES = [(N, S) for N in (8, 16) for S in (1, 7, 64, 256)]


@pytest.mark.parametrize("N,S", CASES)
@pytest.mark.parametrize("realistic", (False, True))
def test_plain_version_and_op_match_the_references_oracle(N, S, realistic):
    arrays = _inputs(N * 1000 + S, 2, S, 24, N, realistic)
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in arrays)
    jy, jh = jax_scan_ref(*map(jnp.asarray, arrays))
    scale = _term_scale(_h_steps(dA, dBx, h0), C)
    for fn in (selective_scan_ref, selective_scan):
        y, h = fn(dA, dBx, C, h0)
        _assert_close(jy, y, scale, 1e-6)
        _assert_close(jh, h, h.abs(), 1e-6)


@pytest.mark.parametrize("N,S", CASES)
def test_op_matches_the_chunked_scan_the_block_serves(N, S):
    arrays = _inputs(N * 7 + S, 2, S, 24, N, realistic=True)
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in arrays)
    jy, jh = _ssm_scan_chunked(*map(jnp.asarray, arrays))
    y, h = selective_scan(dA, dBx, C, h0)
    _assert_close(jy, y, _term_scale(_h_steps(dA, dBx, h0), C), 1e-5)
    _assert_close(jh, h, h.abs(), 1e-5)


def test_plain_version_carries_state_across_calls():
    """Two halves, the second from the first's h_final, are the whole
    scan (decode continues a prefill this way)."""
    dA, dBx, C, h0 = map(torch.from_numpy, _inputs(3, 2, 10, 8, 8))
    y, h = selective_scan(dA, dBx, C, h0)
    y1, h1 = selective_scan(dA[:, :6], dBx[:, :6], C[:, :6], h0)
    y2, h2 = selective_scan(dA[:, 6:].contiguous(), dBx[:, 6:].contiguous(),
                            C[:, 6:].contiguous(), h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    y0, hz = selective_scan(dA[:, :0], dBx[:, :0], C[:, :0], h0)
    assert y0.shape == (2, 0, 8) and torch.equal(hz, h0)


def test_op_rejects_what_k8_cannot_take():
    dA, dBx, C, h0 = map(torch.from_numpy, _inputs(4, 2, 5, 8, 8))
    assert STATE_WIDTHS == (1, 2, 4, 8, 16, 32)
    for bad_n in (3, 12, 64):
        a = torch.ones(2, 5, 8, bad_n)
        with pytest.raises(ValueError, match="state width"):
            selective_scan(a, a, torch.ones(2, 5, bad_n),
                           torch.ones(2, 8, bad_n))
    with pytest.raises(ValueError, match="float32"):
        selective_scan(dA.double(), dBx.double(), C.double(), h0.double())
    with pytest.raises(ValueError, match="float32"):
        selective_scan(dA, dBx, C.to(torch.bfloat16), h0)
    with pytest.raises(ValueError, match=r"\[B, S, di, N\]"):
        selective_scan(dA, dBx[:, :4], C, h0)
    with pytest.raises(ValueError, match=r"\[B, S, di, N\]"):
        selective_scan(dA[0], dBx[0], C, h0)
    with pytest.raises(ValueError, match="C must be"):
        selective_scan(dA, dBx, C[:, :4], h0)
    with pytest.raises(ValueError, match="C must be"):
        selective_scan(dA, dBx, C, h0[:, :4])
    # the launch wrapper refuses CPU tensors: no quiet plain version
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_launch(dA, dBx, C, h0)


# -------------------------------------------- the discretizing entry


def _disc_inputs(seed, B, S, di, N, x_bf16):
    """dt = softplus(N(0, 1)), A = -exp(A_log) with A_log = log(1..N) +
    N(0, 0.1), Bm and Cm N(0, 1), x N(0, 1) (rounded to bf16 when asked),
    h0 N(0, 1): numpy f32 arrays, x as the bf16 values it holds."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, di))))
    A_log = np.log(np.arange(1, N + 1))[None] + 0.1 * rng.normal(
        size=(di, N))
    A = -np.exp(A_log)
    Bm = rng.normal(size=(B, S, N))
    Cm = rng.normal(size=(B, S, N))
    x = rng.normal(size=(B, S, di))
    h0 = rng.normal(size=(B, di, N))
    arrays = [a.astype(np.float32) for a in (dt, A, Bm, Cm, x, h0)]
    if x_bf16:
        arrays[4] = np.asarray(jnp.asarray(arrays[4], jnp.bfloat16))
    return arrays


def _torch(a):
    if a.dtype == np.float32:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def _jax_discretized(dt, A, Bm, Cm, x, h0):
    """The reference's expressions (repro/models/ssm.py:117-121), then
    its oracle."""
    dt, A, Bm, Cm, x, h0 = map(jnp.asarray, (dt, A, Bm, Cm, x, h0))
    deltaA = jnp.exp(dt[..., None] * A)
    deltaBx = dt[..., None] * Bm[:, :, None, :] * x.astype(
        jnp.float32)[..., None]
    return jax_scan_ref(deltaA, deltaBx, Cm, h0)


DISC_CASES = [(N, S) for N in STATE_WIDTHS for S in (1, 3, 64, 256)]


@pytest.mark.parametrize("N,S", DISC_CASES)
@pytest.mark.parametrize("x_bf16", (False, True))
def test_discretized_plain_version_matches_the_reference(N, S, x_bf16):
    arrays = _disc_inputs(N * 100 + S, 2, S, 24, N, x_bf16)
    jy, jh = _jax_discretized(*arrays)
    dt, A, Bm, Cm, x, h0 = map(_torch, arrays)
    assert x.dtype == (torch.bfloat16 if x_bf16 else torch.float32)
    dA, dBx = discretize(dt, A, Bm, x)
    scale = _term_scale(_h_steps(dA, dBx, h0), Cm)
    for fn in (selective_scan_discretized_ref, selective_scan_discretized):
        y, h = fn(dt, A, Bm, Cm, x, h0)
        _assert_close(jy, y, scale, 1e-6)
        _assert_close(jh, h, h.abs(), 1e-6)


def test_discretize_is_the_blocks_eager_expressions():
    """``discretize`` (in place where it can) gives the bits of the plain
    expressions, f32 and bf16 x."""
    for x_bf16 in (False, True):
        dt, A, Bm, _, x, _ = map(_torch, _disc_inputs(5, 2, 9, 16, 8,
                                                      x_bf16))
        dA, dBx = discretize(dt, A, Bm, x)
        assert torch.equal(dA, torch.exp(dt[..., None] * A))
        assert torch.equal(dBx, dt[..., None] * Bm[:, :, None, :]
                           * x.float()[..., None])


@pytest.mark.parametrize("N,S", CASES)
@pytest.mark.parametrize("realistic", (False, True))
def test_channel_decomposition_matches_the_oracle(N, S, realistic):
    """K8's own order: y over n ascending, rounded apart; h the plain
    version's bit for bit."""
    arrays = _inputs(N * 31 + S, 2, S, 24, N, realistic)
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in arrays)
    jy, jh = jax_scan_ref(*map(jnp.asarray, arrays))
    y, h = selective_scan_channel_ref(dA, dBx, C, h0)
    _assert_close(jy, y, _term_scale(_h_steps(dA, dBx, h0), C), 1e-6)
    _assert_close(jh, h, h.abs(), 1e-6)
    py, ph = selective_scan_ref(dA, dBx, C, h0)
    assert torch.equal(h, ph)
    # the first term alone, then the sum left to right
    hs = _h_steps(dA, dBx, h0)
    want = hs[..., 0] * C[:, :, None, 0]
    for n in range(1, N):
        want = want + hs[..., n] * C[:, :, None, n]
    assert torch.equal(y, want)


def test_discretized_entry_carries_state_across_calls():
    """Prefill then single steps from the carried h are the whole scan."""
    dt, A, Bm, Cm, x, h0 = map(_torch, _disc_inputs(6, 2, 8, 16, 8, True))
    y, h = selective_scan_discretized(dt, A, Bm, Cm, x, h0)
    ys, hc = [], h0
    for t0, t1 in ((0, 5), (5, 6), (6, 7), (7, 8)):
        dt_t, Bm_t, Cm_t, x_t = (a[:, t0:t1].contiguous()
                                 for a in (dt, Bm, Cm, x))
        yt, hc = selective_scan_discretized(dt_t, A, Bm_t, Cm_t, x_t, hc)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(hc, h)
    y0, hz = selective_scan_discretized(dt[:, :0], A, Bm[:, :0], Cm[:, :0],
                                        x[:, :0], h0)
    assert y0.shape == (2, 0, 16) and torch.equal(hz, h0)


def test_discretized_entry_refuses_what_k8_cannot_take():
    dt, A, Bm, Cm, x, h0 = map(_torch, _disc_inputs(7, 2, 5, 8, 8, False))
    ok = dict(dt=dt, A=A, Bm=Bm, Cm=Cm, x=x, h0=h0)

    def call(**bad):
        return selective_scan_discretized(**(ok | bad))

    for bad_n in (3, 12, 64):
        with pytest.raises(ValueError, match="state width"):
            call(A=torch.ones(8, bad_n), Bm=torch.ones(2, 5, bad_n),
                 Cm=torch.ones(2, 5, bad_n), h0=torch.ones(2, 8, bad_n))
    for name, t in (("dt", dt.double()), ("A", A.double()),
                    ("Bm", Bm.to(torch.bfloat16)), ("Cm", Cm.double()),
                    ("h0", h0.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="float32"):
            call(**{name: t})
    with pytest.raises(ValueError, match="x must be"):
        call(x=x.double())
    with pytest.raises(ValueError, match="x must be"):
        call(x=x.to(torch.float16))
    with pytest.raises(ValueError, match=r"dt must be \[B, S, di\]"):
        call(dt=dt[0])
    with pytest.raises(ValueError, match=r"A must be"):
        call(A=A[:4])
    for name in ("Bm", "Cm", "x"):
        with pytest.raises(ValueError, match=f"{name} must be"):
            call(**{name: ok[name][:, :4]})
    with pytest.raises(ValueError, match="h0 must be"):
        call(h0=h0[:, :4])
    # the launch wrapper refuses CPU tensors: no quiet plain version
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_discretized_launch(dt, A, Bm, Cm, x, h0)
