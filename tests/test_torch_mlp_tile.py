"""Port parity: the tiled schedule of K3, K5 and K6 (``mlp_tile.cuh``).

``kernels.fused_mlp.mlp_tile_ref`` writes the kernels' schedule out
plainly: tiles of rows with a zero-padded last tile, each layer's weights
in chunks of input rows with a shorter last chunk, each output one chain
over ascending input index.  It is held against the JAX ``fused_mlp``,
``fused_mlp_classify`` and ``fused_dag`` (Pallas, interpret mode, as
``tests/test_torch_fused_mlp.py`` runs them) at the full-width models of
the design space, a 256-wide model, 16 layers and a 1-wide input, on 1,
37 and 200 rows.  Logits agree within rtol=atol=1e-5 (the two frameworks
sum in different orders); verdicts may differ only on rows whose top-two
margin is within ``testing.MARGIN`` (a DAG row when any leaf's is), and
the test counts those rows.  The tiles and chunks themselves change no
bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_mlp as jfm  # noqa: E402

from repro_torch.kernels import fused_mlp as tfm  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    AD_FULL_WIDTHS,
    MARGIN,
    he_mlp,
    verdict_mismatches,
)

FULL = (128,) * 10
WIDTHS = {"full7": (7,) + FULL + (2,), "full30": (30,) + FULL + (2,),
          "full47": (47,) + FULL + (2,), "w256": (64, 256, 256, 10),
          "deep16": (20,) + (48,) * 15 + (3,), "tiny": (1, 4, 2)}
ROWS = (1, 37, 200)
TILE, K_CHUNK = 16, 24                  # both ragged at 37 and 200 rows
N = max(ROWS)
_JAX = {}


def _x(d0, seed):
    return (np.random.default_rng(seed).normal(size=(N, d0)) * 3
            ).astype(np.float32)


def _jax_mlp(key):
    """The JAX logits and verdicts of WIDTHS[key] on N seeded rows (one
    interpret-mode call each; rows are independent, so the first B rows
    are the answer at B)."""
    if key not in _JAX:
        widths = WIDTHS[key]
        ws, bs = he_mlp(widths, seed=len(widths))
        x = _x(widths[0], seed=3)
        lane = 256 if max(widths) > jfm.LANE else None
        jw = [jnp.asarray(w) for w in ws]
        jb = [jnp.asarray(b) for b in bs]
        _JAX[key] = (ws, bs, x,
                     np.asarray(jfm.fused_mlp(jnp.asarray(x), jw, jb,
                                              lane=lane)),
                     np.asarray(jfm.fused_mlp_classify(jnp.asarray(x), jw, jb,
                                                       lane=lane)))
    return _JAX[key]


def _tile(x, ws, bs, rows=TILE, k_chunk=K_CHUNK):
    return tfm.mlp_tile_ref(torch.as_tensor(x),
                            [torch.as_tensor(w) for w in ws],
                            [torch.as_tensor(b) for b in bs], rows, k_chunk)


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("key", list(WIDTHS))
def test_tile_logits_match_jax_fused_mlp(key, B):
    ws, bs, x, jl, _ = _jax_mlp(key)
    got = _tile(x[:B], ws, bs).numpy()
    assert got.shape == (B, WIDTHS[key][-1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, jl[:B], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("key", list(WIDTHS))
def test_tile_verdicts_match_jax_classify(key, B):
    ws, bs, x, jl, jv = _jax_mlp(key)
    tv = torch.argmax(_tile(x[:B], ws, bs), dim=1).numpy()
    bad, close = verdict_mismatches(tv, jl[:B])
    print(f"{key} B={B}: {close} of {B} rows within the margin")
    assert bad == 0 and close <= B // 100
    assert verdict_mismatches(jv[:B], jl[:B])[0] == 0


@pytest.mark.parametrize("rows,k_chunk", [(1, 1), (8, 24), (32, 256),
                                          (7, 5)])
def test_tiles_and_chunks_change_no_bit(rows, k_chunk):
    ws, bs, x, _, _ = _jax_mlp("full30")
    want = _tile(x[:37], ws, bs, rows=37, k_chunk=128)
    assert torch.equal(_tile(x[:37], ws, bs, rows, k_chunk), want)


def _jax_dag(models, plan, x):
    """The JAX ``fused_dag`` (interpret mode), each model packed at its
    own snapped lane as ``pallas_backend.lower_dag_pallas`` packs it."""
    stacks, lanes = [], []
    for ws, bs in models:
        lane = jfm.snap_lane([ws[0].shape[0]] + [w.shape[1] for w in ws],
                             interpret=True)
        w_stack, b_stack = jfm.pack_params([jnp.asarray(w) for w in ws],
                                           [jnp.asarray(b) for b in bs],
                                           lane)
        stacks += [w_stack, b_stack]
        lanes.append(lane)
    return np.asarray(jfm.fused_dag(
        jnp.asarray(x), tuple(stacks),
        n_layers=tuple(len(ws) for ws, _ in models),
        n_classes=tuple(int(ws[-1].shape[1]) for ws, _ in models),
        lanes=tuple(lanes), plan=plan, interpret=True))


DAGS = {
    "ad_full>tc": ([AD_FULL_WIDTHS, (7, 2)],
                   ("seq", (("model", 0), ("model", 1)))),
    "full|full": ([AD_FULL_WIDTHS, AD_FULL_WIDTHS],
                  ("or", (("model", 0), ("model", 1)))),
}
_JAX_DAG = {}


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("name", list(DAGS))
def test_tile_dag_matches_jax_fused_dag(name, B):
    widths, plan = DAGS[name]
    models = [he_mlp(w, seed=11 + i) for i, w in enumerate(widths)]
    x = _x(7, seed=4)
    if name not in _JAX_DAG:
        _JAX_DAG[name] = _jax_dag(models, plan, x)
    jv = _JAX_DAG[name][:B]
    logits = [_tile(x[:B], ws, bs) for ws, bs in models]
    got = tfm.eval_dag_program(
        tfm.encode_plan(plan),
        [torch.argmax(lg, dim=1).to(torch.int32) for lg in logits]).numpy()
    close = np.zeros(B, bool)
    for (ws, bs), lg in zip(models, logits):
        top = np.sort(tfm.mlp_ref(torch.as_tensor(x[:B]),
                                  [torch.as_tensor(w) for w in ws],
                                  [torch.as_tensor(b) for b in bs]).numpy(),
                      1)
        close |= (top[:, -1] - top[:, -2]) <= MARGIN
    bad = int(((got != jv) & ~close).sum())
    print(f"{name} B={B}: {int(close.sum())} of {B} rows within a leaf's "
          "margin")
    assert bad == 0 and close.sum() <= max(1, B // 50)
    assert got.dtype == np.int32 and got.shape == (B,)
