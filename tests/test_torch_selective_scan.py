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
    selective_scan,
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
