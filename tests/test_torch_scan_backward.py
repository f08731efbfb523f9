"""K8b's plain versions and ``SelectiveScanFn`` (the gradient of K8's
discretizing entry, ``repro_torch.kernels.selective_scan``) against the
reference, on CPU tensors.

The reference has no hand-written gradient: it trains through
``jax.vjp`` of its own expressions, the discretization of
``repro/models/ssm.py:117-121`` composed with its chunked associative
scan (``_ssm_scan_chunked``, what its Mamba block trains through) or with
its oracle (``selective_scan_ref``).  Both plain versions,
``selective_scan_bwd_ref`` (the reverse recurrence over whole steps) and
``selective_scan_bwd_chunked_ref`` (K8b's schedule: checkpoints every T
steps, each chunk recomputed and walked backward, the sums over
channels and batch in the kernel's order), are held against both, every
input's gradient.

Tolerance: each f32 gradient within 1e-5 of its largest value.  The
plain versions lie up to 6.1e-7 of it from ``jax.vjp`` on these shapes
(sums over up to 50 steps and 130 channels; 4.6e-7 through the chunked
scan, whose products and sums run in another order), and 1-3e-7 from
each other.  A bf16
dx is also allowed one bf16 step (2^-8) of each value: a last-bit
difference of its f32 sum can round it either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import (
    selective_scan_ref as jax_scan_ref,
)
from repro.models.ssm import _ssm_scan_chunked
from repro_torch.kernels import _ext
from repro_torch.kernels.selective_scan import (
    SelectiveScanFn,
    bwd_channels,
    bwd_chunk,
    scan_checkpoints,
    selective_scan_bwd_chunked_ref,
    selective_scan_bwd_launch,
    selective_scan_bwd_ref,
    selective_scan_discretized,
    selective_scan_discretized_launch,
    selective_scan_discretized_ref,
)
from repro_torch.kernels.selective_scan.ref import _block_sums, _lane_sums

TOL = 1e-5
NAMES = ("ddt", "dA", "dBm", "dCm", "dx", "dh0")
# B, S, di, N, x dtype, h0 (random or zero), dh_final (random or zero):
# a chunk edge (S = 16 at N = 8, whose chunk is 8 steps), S = 1, a
# ragged last chunk (S = 50) over two blocks of channels (di = 130), N =
# 16 and 4, x in bf16 and f32
CASES = (
    (2, 16, 24, 8, "float32", "zero", "zero"),
    (2, 32, 40, 16, "bfloat16", "random", "random"),
    (1, 1, 8, 4, "float32", "random", "random"),
    (1, 50, 130, 8, "bfloat16", "zero", "random"),
)
PLAIN = {"recurrence": selective_scan_bwd_ref,
         "chunked": selective_scan_bwd_chunked_ref}


def _inputs(seed, B, S, di, N, xdt, h0_kind, dh_kind):
    """dt = softplus(N(0, 1)), A = -exp(N(0, 1)), Bm, Cm, x, h0, dy and
    dh_final N(0, 1), as numpy f32 arrays (x rounded to bf16 where asked;
    h0 and dh_final zero where asked)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    A = -np.exp(f(di, N))
    Bm, Cm, x, h0 = f(B, S, N), f(B, S, N), f(B, S, di), f(B, di, N)
    dy, dh = f(B, S, di), f(B, di, N)
    if xdt == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if h0_kind == "zero":
        h0 = np.zeros_like(h0)
    return dt, A, Bm, Cm, x, h0, dy, None if dh_kind == "zero" else dh


def _torch(arrays, xdt):
    dt, A, Bm, Cm, x, h0, dy, dh = (None if a is None else torch.from_numpy(a)
                                    for a in arrays)
    return dt, A, Bm, Cm, x.to(getattr(torch, xdt)), h0, dy, dh


def _jax_grads(arrays, xdt, scan):
    """``jax.vjp`` of the reference's discretization (ssm.py:117-121)
    composed with ``scan``, at (dy, dh_final) -> every input's
    gradient."""
    dt, A, Bm, Cm, x, h0, dy, dh = arrays

    def f(dt, A, Bm, Cm, x, h0):
        deltaA = jnp.exp(dt[..., None] * A)
        deltaBx = (dt[..., None] * Bm[:, :, None, :]
                   * x.astype(jnp.float32)[..., None])
        return scan(deltaA, deltaBx, Cm, h0)

    xj = jnp.asarray(x, getattr(jnp, xdt))
    (_, h), vjp = jax.vjp(f, *map(jnp.asarray, (dt, A, Bm, Cm)), xj,
                          jnp.asarray(h0))
    return vjp((jnp.asarray(dy), jnp.zeros_like(h) if dh is None
                else jnp.asarray(dh)))


def _close(got, want, what, bf16_step=False):
    """Every output within TOL of its largest value; dx also within 2^-8
    of each value or, with ``bf16_step``, within one bf16 step of it (the
    spacing of bf16 at its binade, 2^-8 to 2^-7 of the value)."""
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32)) if not isinstance(
            w, torch.Tensor) else w.float().numpy()
        g = g.float().numpy()
        assert g.shape == w.shape, (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        step = (np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
                if bf16_step else 2.0 ** -8 * np.abs(w))
        allow = TOL * scale + (step if name == "dx" else 0)
        d = np.abs(g - w)
        assert bool((d <= allow).all()), (what, name, float(d.max()) / scale)


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("scan", ("chunked", "sequential"))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_gradients_match_jax_vjp_of_the_references_scan(case, scan,
                                                              plain):
    arrays = _inputs(sum(case[:4]), *case)
    want = _jax_grads(arrays, case[4], {
        "chunked": _ssm_scan_chunked,
        "sequential": lambda dA, dBx, C, h0: jax_scan_ref(dA, dBx, C, h0),
    }[scan])
    got = PLAIN[plain](*_torch(arrays, case[4]))
    assert got[4].dtype == getattr(torch, case[4])
    _close(got, want, f"{plain} against jax.vjp through the {scan} scan")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_recurrence_matches_autograd_of_the_plain_forward(case):
    """``selective_scan_bwd_ref`` against autograd's gradient of
    ``selective_scan_discretized_ref`` (the same forward, differentiated
    op by op), at dy and dh_final."""
    dt, A, Bm, Cm, x, h0, dy, dh = _torch(_inputs(7, *case), case[4])
    leaves = [t.clone().requires_grad_() for t in (dt, A, Bm, Cm, x, h0)]
    y, h = selective_scan_discretized_ref(*leaves)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    _close(selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy, dh),
           torch.autograd.grad(loss, leaves), "recurrence against autograd")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_schedule_matches_autograd_of_the_plain_forward(case):
    """K8b's schedule written out (its states over lanes, the lanes' and
    the channels' butterflies) against autograd's gradient of
    ``selective_scan_discretized_ref``, at dy and dh_final.  A bf16 dx is
    held to one bf16 step of each value: autograd rounds its own f32 sum
    to bf16 once, as both plain versions do, and where the two f32 sums
    differ in the last bit the roundings can land a step apart (at seed 8
    one value of the 130 x 50 does so, for the recurrence as for the
    chunked version: -0.84375 against -0.83984375, 1.2 x 2^-8 of it)."""
    dt, A, Bm, Cm, x, h0, dy, dh = _torch(_inputs(8, *case), case[4])
    leaves = [t.clone().requires_grad_() for t in (dt, A, Bm, Cm, x, h0)]
    y, h = selective_scan_discretized_ref(*leaves)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    _close(selective_scan_bwd_chunked_ref(dt, A, Bm, Cm, x, h0, dy, dh),
           torch.autograd.grad(loss, leaves), "chunked against autograd",
           bf16_step=True)


@pytest.mark.parametrize("N", (1, 2, 4, 8, 16, 32))
def test_chunked_schedule_holds_at_every_state_width(N):
    """The chunked version at every state width, each with K8b's own
    chunk (16 steps at N <= 4, 2 at N = 32) over an S that it does not
    divide, and its own lanes a channel (1 at N <= 4, N / 4 above) and
    channels a block (256 / lanes) over a di whose last block is ragged,
    against the recurrence."""
    case = (2, 37, 140, N, "float32", "random", "random")
    t = _torch(_inputs(3, *case), "float32")
    assert 37 % bwd_chunk(N) and 140 % bwd_channels(N)
    _close(selective_scan_bwd_chunked_ref(*t), selective_scan_bwd_ref(*t),
           f"N {N}")


def test_checkpoints_are_the_forwards_states():
    """h entering chunk c is bit for bit the plain forward's h_final over
    the first c x T steps (K8 writes the same states under autograd);
    K8b's chunk is SSB_HIST / N steps (64 / N), at most SSB_MAX_T (16)."""
    assert [bwd_chunk(n) for n in (1, 2, 4, 8, 16, 32)] == [16, 16, 16, 8,
                                                            4, 2]
    dt, A, Bm, Cm, x, h0, _, _ = _torch(
        _inputs(4, 2, 18, 30, 16, "bfloat16", "random", "zero"), "bfloat16")
    T = bwd_chunk(16)
    ckpt = scan_checkpoints(dt, A, Bm, x, h0, T)
    assert ckpt.shape == (2, 5, 30, 16)
    assert torch.equal(ckpt[:, 0], h0)
    for c in (1, 2, 3, 4):
        _, h = selective_scan_discretized_ref(
            dt[:, :c * T], A, Bm[:, :c * T], Cm[:, :c * T], x[:, :c * T], h0)
        assert torch.equal(ckpt[:, c], h)


@pytest.mark.parametrize("N", (4, 8, 16, 32))
@pytest.mark.parametrize("di", (1, 31, 128, 129, 300))
def test_block_sums_are_the_channel_sums(di, N):
    """K8b's sums over a block's channels (256 at N <= 4, 128 at 8, 64 at
    16, 32 at 32: the warps' butterflies over their channels, then the
    warps in order): exact on integers, and the plain sum within f32
    rounding on random values; channels past di add nothing."""
    rng = np.random.default_rng(di + N)
    ch = bwd_channels(N)
    assert ch == 256 // max(1, N // 4)
    nblk = -(-di // ch)

    def plain(v):
        return torch.cat([v, v.new_zeros((2, nblk * ch - di, N))], 1
                         ).reshape(2, nblk, ch, N)

    v = torch.from_numpy(rng.integers(-50, 50, (2, di, N)).astype(np.float32))
    assert torch.equal(_block_sums(v, nblk), plain(v).sum(2))
    v = torch.from_numpy(rng.normal(size=(2, di, N)).astype(np.float32))
    want = plain(v).double().sum(2)
    assert float((_block_sums(v, nblk).double() - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("N", (1, 2, 4, 8, 16, 32))
def test_lane_sums_are_the_sums_over_n(N):
    """K8b's sums over a channel's states (a pairwise tree: each lane's
    4, then the channel's N / 4 lanes by the butterfly, adjacent lanes
    first): exact on integers, the plain sum within f32 rounding on
    random values, and at N = 16 the tree written out."""
    rng = np.random.default_rng(N)
    v = torch.from_numpy(rng.integers(-50, 50, (3, 5, N)).astype(np.float32))
    assert torch.equal(_lane_sums(v), v.sum(-1))
    v = torch.from_numpy(rng.normal(size=(3, 5, N)).astype(np.float32))
    assert float((_lane_sums(v).double() - v.double().sum(-1)).abs().max()
                 ) <= 1e-5
    if N == 16:
        lane = [(v[..., 4 * j] + v[..., 4 * j + 1])
                + (v[..., 4 * j + 2] + v[..., 4 * j + 3]) for j in range(4)]
        assert torch.equal(_lane_sums(v), (lane[0] + lane[1])
                           + (lane[2] + lane[3]))


@pytest.mark.parametrize("xdt", ("float32", "bfloat16"))
def test_function_on_cpu_tensors_gives_the_plain_gradients(xdt):
    """Under autograd ``selective_scan_discretized`` runs SelectiveScanFn:
    the plain forward and ``selective_scan_bwd_ref``, bit for bit, no
    extension, no counted launch; dh0 only where h0 requires a gradient;
    without grad it builds no graph."""
    dt, A, Bm, Cm, x, h0, dy, dh = _torch(
        _inputs(5, 2, 24, 20, 8, xdt, "random", "random"), xdt)
    before = dict(_ext.LAUNCHES)
    for with_h0 in (True, False):
        leaves = [t.clone().requires_grad_() for t in (dt, A, Bm, Cm, x)]
        h0_in = h0.clone().requires_grad_(with_h0)
        y, h = selective_scan_discretized(*leaves, h0_in)
        assert type(y.grad_fn) is SelectiveScanFn._backward_cls
        want_y, want_h = selective_scan_discretized_ref(dt, A, Bm, Cm, x, h0)
        assert torch.equal(y.detach(), want_y)
        assert torch.equal(h.detach(), want_h)
        torch.autograd.backward((y, h), (dy, dh))
        want = selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy, dh)
        for leaf, w in zip(leaves, want):
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, w)
        assert (torch.equal(h0_in.grad, want[5]) if with_h0
                else h0_in.grad is None)
    # y alone: h_final's gradient is None, taken as zero
    leaves = [t.clone().requires_grad_() for t in (dt, A, Bm, Cm, x)]
    y, _ = selective_scan_discretized(*leaves, h0)
    y.backward(dy)
    want = selective_scan_bwd_ref(dt, A, Bm, Cm, x, h0, dy)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert selective_scan_discretized(*leaves, h0)[0].grad_fn is None
    assert selective_scan_discretized(dt, A, Bm, Cm, x, h0)[0].grad_fn is None
    assert _ext.LAUNCHES == before


def test_mamba_block_trains_through_the_function():
    """The Mamba block's parameter gradients on ``backend="cuda"`` (the
    discretizing entry: SelectiveScanFn, its plain backward on CPU
    tensors) against ``"interpret"`` (autograd through the eager
    discretization and recurrence), within 1e-5 of each largest value."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    from repro_torch.models.registry import init_params

    cfg = get_smoke_config("jamba-1.5-large-398b")
    p = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", dtype=torch.float32)["layers"][0]["mamba"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32))
    grads = {}
    for backend in ("cuda", "interpret"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        out = ssm.mamba_apply(leaves, x, cfg, backend=backend)
        out.square().mean().backward()
        grads[backend] = {k: v.grad for k, v in leaves.items()}
    for k, w in grads["interpret"].items():
        g = grads["cuda"][k]
        assert float((g - w).abs().max()) <= TOL * float(w.abs().max()), k


def test_launch_wrappers_take_cuda_tensors_only():
    """K8b's wrapper and K8's checkpointing launch refuse CPU tensors
    (never moving to a plain version); K8b's wrapper checks dy's and the
    checkpoints' shapes first."""
    dt, A, Bm, Cm, x, h0, dy, dh = _torch(
        _inputs(6, 1, 10, 8, 4, "float32", "zero", "zero"), "float32")
    ckpt = scan_checkpoints(dt, A, Bm, x, h0, bwd_chunk(4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt, dy)
    with pytest.raises(ValueError, match="ckpt"):
        selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt[:, :, :4], dy)
    with pytest.raises(ValueError, match="dy"):
        selective_scan_bwd_launch(dt, A, Bm, Cm, x, ckpt, dy[:, :3])
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_discretized_launch(dt, A, Bm, Cm, x, h0,
                                          checkpoint=True)
