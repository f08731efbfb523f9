"""K9's plain version and op (``repro_torch.kernels.binarized_gemm``)
against the reference's op (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it on the CPU) and its oracle
``binarized_gemm_ref``, on CPU tensors.

Tolerance: none.  The result is an integer dot product of +-1 vectors,
exact in both packages, so every comparison is equality.  The kernel
itself runs only on the card: ``chip_smoke.py`` (``kernels_check_bgemm``)
holds it to this plain version int for int.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.binarized_gemm import binarized_gemm as jax_bgemm
from repro.kernels.binarized_gemm import binarized_gemm_ref as jax_ref
from repro.kernels.binarized_gemm import sign_pm1 as jax_sign
from repro_torch.kernels.binarized_gemm import (
    K_TILE,
    binarized_gemm,
    binarized_gemm_launch,
    binarized_gemm_ref,
    sign_pack_ref,
    sign_pm1,
)

HSET = settings(max_examples=12, deadline=None)


def _planted(rng, b, k, n):
    """Normal draws with 0, -0.0 and NaN planted in both operands."""
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    for a in (x, w):
        flat = a.reshape(-1)
        pos = rng.choice(flat.size, size=min(9, flat.size), replace=False)
        flat[pos[0::3]] = 0.0
        flat[pos[1::3]] = -0.0
        flat[pos[2::3]] = np.nan
    return x, w


@given(
    b=st.integers(1, 64),
    k=st.integers(2, 200),
    n=st.integers(1, 64),
    seed=st.integers(0, 2**31),
)
@HSET
def test_binarized_gemm_matches_reference(b, k, n, seed):
    """The draws of ``tests/test_kernels.py:178-198``: the port's op equals
    the reference's op (interpret mode) and its oracle exactly, and the
    result has k's parity."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    got = binarized_gemm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n)
    got = got.numpy()
    want_op = np.asarray(jax_bgemm(jnp.asarray(x), jnp.asarray(w), block=16))
    want_ref = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w)), np.int32)
    np.testing.assert_array_equal(got, want_op)
    np.testing.assert_array_equal(got, want_ref)
    assert np.all((got - k) % 2 == 0)


@pytest.mark.parametrize("b,k,n", [(37, 200, 45), (1, 2, 1), (8, 33, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_zero_negzero_nan(b, k, n, dtype):
    """0 and -0.0 are +1, NaN is -1, in f32 and bf16 alike."""
    x, w = _planted(np.random.default_rng(b * 1000 + k), b, k, n)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    got = binarized_gemm(tx, tw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ref(jx, jw), np.int32))
    np.testing.assert_array_equal(got, np.asarray(jax_bgemm(jx, jw,
                                                            block=16)))
    np.testing.assert_array_equal(
        binarized_gemm_ref(tx, tw).numpy(), np.asarray(jax_ref(jx, jw)))


def test_sign_convention_matches_reference():
    v = np.array([0.0, -0.0, np.nan, 1e-30, -1e-30, np.inf, -np.inf, 2.5],
                 np.float32)
    got = sign_pm1(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sign(jnp.asarray(v))))
    np.testing.assert_array_equal(got, [1, 1, -1, 1, -1, 1, -1, 1])


def test_mixed_operand_dtypes():
    x, w = _planted(np.random.default_rng(5), 9, 70, 11)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = binarized_gemm(tx, torch.from_numpy(w)).numpy()
    want = jax_ref(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


@pytest.mark.parametrize("x,w,match", [
    (torch.zeros(3, 4), torch.zeros(5, 2), "K"),
    (torch.zeros(3), torch.zeros(3, 2), "K"),
    (torch.zeros(3, 4, dtype=torch.int32), torch.zeros(4, 2), "f32 or bf16"),
    (torch.zeros(0, 4), torch.zeros(4, 2), ">= 1"),
])
def test_op_refuses_bad_operands(x, w, match):
    with pytest.raises(ValueError, match=match):
        binarized_gemm(x, w)


def test_launch_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        binarized_gemm_launch(torch.zeros(2, 3), torch.zeros(3, 4))


@pytest.mark.parametrize("b,k,n", [(37, 200, 45), (1, 1, 1), (8, 128, 7),
                                   (5, 129, 3), (16, 300, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sign_pack_matches_kernel_signs(b, k, n, dtype):
    """K9's first launch written out: xs [B, Kp] and wt [N, Kp] hold the
    JAX kernel's own signs, ``jnp.where(v >= 0, 1, -1).astype(int8)``
    (x's as they are, w's transposed), and zeros past K up to Kp, K
    rounded up to the product's K tile."""
    x, w = _planted(np.random.default_rng(b + k + n), b, k, n)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    xs, wt = sign_pack_ref(tx, tw, K_TILE)
    kp = -(-k // K_TILE) * K_TILE
    assert xs.dtype == wt.dtype == torch.int8
    assert tuple(xs.shape) == (b, kp) and tuple(wt.shape) == (n, kp)
    np.testing.assert_array_equal(
        xs[:, :k].numpy(), np.asarray(jnp.where(jx >= 0, 1, -1)
                                      .astype(jnp.int8)))
    np.testing.assert_array_equal(
        wt[:, :k].numpy(), np.asarray(jnp.where(jw >= 0, 1, -1)
                                      .astype(jnp.int8)).T)
    assert not xs[:, k:].any() and not wt[:, k:].any()


@pytest.mark.parametrize("k", [1, 37, 127, 128, 129, 256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_product_of_packed_signs_matches_reference(k, dtype):
    """The product K9's second launch forms, ``xs @ wt^T`` over the padded
    K in int32, equals the JAX op (its Pallas kernel in interpret mode):
    the zero padding adds nothing, for ragged K and both dtypes."""
    x, w = _planted(np.random.default_rng(k), 19, k, 11)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    xs, wt = sign_pack_ref(tx, tw, K_TILE)
    got = (xs.to(torch.int32) @ wt.to(torch.int32).T).numpy()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    np.testing.assert_array_equal(got, np.asarray(jax_bgemm(jx, jw,
                                                            block=16)))
