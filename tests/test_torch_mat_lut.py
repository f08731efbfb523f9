"""Port parity: the MAT (quantized-LUT) classifier (K4's function) and
K1's ``"mat"`` suffix.

The JAX ``mat_classify`` (Pallas ``mat_lut._kernel``, interpret mode on
the CPU) and the JAX fused launch with a ``"mat"`` plan (Pallas
``_serve_kernel``, interpret mode) against the port's plain versions on
CPU tensors.  Buckets match ``Quantize.apply`` (searchsorted) exactly.
The port sums the scores one feature at a time in ascending order, as
both Pallas kernels do, so its scores equal a numpy ascending sum bit for
bit and its verdicts equal the Pallas kernels' verdicts exactly.  Against
``mat_pipeline_ref`` and ``LUTGather.apply``, which sum with an XLA
reduction in another order, scores agree within rtol=atol=1e-6 and
verdicts under the margin rule (``testing.MARGIN``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pallas_backend as jpb  # noqa: E402
from repro.core import stageir as js  # noqa: E402
from repro.kernels import fused_flow as jff  # noqa: E402
from repro.kernels import mat_lut as jml  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.flowstate.registers import FlowStateSpec  # noqa: E402
from repro_torch.kernels import fused_flow as tff  # noqa: E402
from repro_torch.kernels import mat_lut as tml  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    PATTERNS,
    flow_batch,
    mat_stages,
    verdict_mismatches,
)

SPEC = FlowStateSpec(n_slots=64, n_counters=2, n_ewma=2,
                     hist_sizes=(16, 8), ewma_alpha=0.125)
W = SPEC.width


def _mat(F, bins, C, seed, *, labels=None):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.normal(size=(F, bins - 1)), 1).astype(np.float32)
    tables = rng.random((F, bins, C)).astype(np.float32)
    lmap = (np.arange(C, dtype=np.int32) if labels is None
            else np.asarray(labels, np.int32))
    return edges, tables, lmap


def _x(B, F, edges, seed):
    """Rows that also hit edge values exactly (ties for searchsorted)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, F)) * 1.5).astype(np.float32)
    hit = rng.random((B, F)) < 0.2
    col = rng.integers(0, edges.shape[1], (B, F))
    x[hit] = edges[np.nonzero(hit)[1], col[hit]]
    return x


def _ascending_scores(x, edges, tables):
    scores = np.zeros((len(x), tables.shape[2]), np.float32)
    for f in range(edges.shape[0]):
        b = (x[:, f:f + 1] > edges[f][None]).sum(1)
        scores = scores + tables[f][b]
    return scores


@pytest.mark.parametrize("F,bins,C", [(28, 8, 4), (5, 17, 3), (64, 33, 7)])
def test_buckets_and_scores(F, bins, C):
    edges, tables, _ = _mat(F, bins, C, seed=F)
    x = _x(150, F, edges, seed=bins)
    want = np.asarray(js.Quantize(edges).apply(jnp.asarray(x)))
    got = tml.mat_buckets(torch.as_tensor(x), torch.as_tensor(edges))
    np.testing.assert_array_equal(got.numpy(), want)
    scores = tml.mat_scores_ref(torch.as_tensor(x), torch.as_tensor(edges),
                                torch.as_tensor(tables)).numpy()
    np.testing.assert_array_equal(
        scores.view(np.int32),
        _ascending_scores(x, edges, tables).view(np.int32))
    lut = np.asarray(js.LUTGather(tables).apply(jnp.asarray(want)))
    np.testing.assert_allclose(scores, lut, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_min", [False, True])
@pytest.mark.parametrize("B", [1, 37, 256])
def test_classify_matches_pallas_kernel(use_min, B):
    """Ragged batch sizes; LabelMap shorter than the classes (ids past its
    end map to 0 in both packages)."""
    edges, tables, _ = _mat(12, 9, 5, seed=B)
    lmap = np.asarray([3, 1, 4, 1], np.int32)
    x = _x(B, 12, edges, seed=B + 1)
    jv = np.asarray(jml.mat_classify(jnp.asarray(x), jnp.asarray(edges),
                                     jnp.asarray(tables), jnp.asarray(lmap),
                                     use_min=use_min))
    mat = tml.pack_mat(edges, tables, lmap, use_min=use_min)
    tv = tml.mat_classify(torch.as_tensor(x), mat).numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == np.int32 and tv.shape == (B,)
    # against the XLA-order oracle: the margin rule
    ref = np.asarray(jml.mat_classify_reference(
        jnp.asarray(x), jnp.asarray(edges), jnp.asarray(tables),
        jnp.asarray(np.concatenate([lmap, [0]])), use_min=use_min))
    scores = _ascending_scores(x, edges, tables)
    bad, close = verdict_mismatches(ref, scores, use_min=use_min,
                                    label_map=np.concatenate([lmap, [0]]))
    print(f"B={B} use_min={use_min}: {close} rows within the margin")
    assert bad == 0


def test_mat_fused_tables_have_no_margin_rows():
    """The mat-fused classifier at its reference tables: the port's
    verdicts equal the JAX stage walk's on a whole readout batch."""
    stages = mat_stages(W)
    edges, tables = stages[0].edges, stages[1].tables
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(1, 12, (400, 1)),
                        rng.random((400, W - 1)) * 2], 1).astype(np.float32)
    jstages = [js.Quantize(edges), js.LUTGather(tables), js.Reduce("argmax"),
               js.LabelMap(np.asarray([0, 1, 1, 0], np.int32))]
    jv = np.asarray(js.apply_stages(jstages, jnp.asarray(x)))
    mat = tml.pack_mat(edges, tables, stages[3].table)
    tv = tml.mat_classify(torch.as_tensor(x), mat).numpy()
    np.testing.assert_array_equal(tv, jv)
    _, close = verdict_mismatches(tv, _ascending_scores(x, edges, tables),
                                  label_map=np.asarray([0, 1, 1, 0]))
    assert close == 0


def test_launch_wrapper_refuses_cpu_tensors():
    edges, tables, lmap = _mat(4, 5, 2, seed=0)
    mat = tml.pack_mat(edges, tables, lmap)
    with pytest.raises(ValueError, match="CUDA"):
        tml.mat_classify_launch(torch.zeros((3, 4)), mat)


@pytest.mark.parametrize("shape,reason", [
    ((65, 7, 8, 2, 2), "features"),
    ((4, 1024, 1025, 2, 2), "bins"),
    ((4, 7, 8, 129, 2), "classes"),
    ((64, 127, 128, 8, 8), "shared memory"),
    ((4, 7, 9, 2, 2), "bin count"),
])
def test_envelope_reasons(shape, reason):
    assert reason in tml.mat_envelope_reason(*shape)
    assert tml.mat_envelope_reason(28, 7, 8, 4, 4) is None


# ---------------------------------- K4's own schedule and the Tofino shape

TOFINO = (7, 512, 2)       # path_generate's Tofino MAT: F, bins, classes


def _tofino(seed, *, unsorted):
    """The codegen's evenly spaced edges over a symmetric range (0.0
    exactly at the middle edge), one row shuffled with ``unsorted``."""
    F, bins, C = TOFINO
    rng = np.random.default_rng(seed)
    hi = rng.random(F) * 4 + 1
    edges = np.stack([np.linspace(-h, h, bins + 1)[1:-1] for h in hi]
                     ).astype(np.float32)
    edges[:, (bins - 2) // 2] = 0.0
    if unsorted:
        rng.shuffle(edges[3])
    tables = rng.normal(size=(F, bins, C)).astype(np.float32)
    return edges, tables


def _planted(B, edges, seed):
    """Rows with edge values exactly, NaN, +inf, -inf, -0.0 and 0.0."""
    F = edges.shape[0]
    x = (_x(B, F, edges, seed) if edges.shape[1] else
         np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32))
    u = np.random.default_rng(seed + 1).random(x.shape)
    for i, v in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0)):
        x[(u >= 0.03 * i) & (u < 0.03 * (i + 1))] = v
    return x


@pytest.mark.parametrize("unsorted", [False, True])
@pytest.mark.parametrize("use_min", [False, True])
def test_tofino_shape_matches_pallas_kernel(unsorted, use_min):
    """7 features, 512 bins (511 edges, so K4 splits each count across the
    warp), 2 classes: the Pallas kernel (interpret mode) against the
    port's plain version and K4's schedule written out, exactly."""
    edges, tables = _tofino(5, unsorted=unsorted)
    x = _planted(96, edges, seed=7)
    lmap = np.asarray([1, 0], np.int32)
    jv = np.asarray(jml.mat_classify(jnp.asarray(x), jnp.asarray(edges),
                                     jnp.asarray(tables), jnp.asarray(lmap),
                                     use_min=use_min))
    mat = tml.pack_mat(edges, tables, lmap, use_min=use_min)
    xt = torch.as_tensor(x)
    tv = tml.mat_classify(xt, mat).numpy()
    np.testing.assert_array_equal(tv, jv)
    sv = tml.mat_classify_split_ref(xt, mat.edges, mat.tables, mat.lmap,
                                    use_min=use_min).numpy()
    np.testing.assert_array_equal(sv, jv)


@pytest.mark.parametrize("F,bins,C", [
    (7, 512, 2), (28, 8, 4), (3, 33, 3), (3, 34, 5), (9, 41, 100),
    (64, 2, 128), (2, 1, 3), (5, 1024, 1)])
@pytest.mark.parametrize("use_min", [False, True])
def test_split_schedule_matches_plain_version(F, bins, C, use_min):
    """``mat_classify_split_ref`` (the bucket count split over 32 lanes of
    a row padded with +inf, the scores from loads fetched a chunk ahead)
    equals ``mat_classify_ref`` bit for bit: either side of the split at
    32 edges, one bin, the most bins, one and 128 classes."""
    edges, tables, _ = _mat(F, bins, C, seed=F * bins)
    x = torch.as_tensor(_planted(64, edges, seed=C))
    e, t = torch.as_tensor(edges), torch.as_tensor(tables)
    lmap = torch.arange(C, dtype=torch.int32).flip(0)
    np.testing.assert_array_equal(
        tml.mat_classify_split_ref(x, e, t, lmap, use_min=use_min).numpy(),
        tml.mat_classify_ref(x, e, t, lmap, use_min=use_min).numpy())


@pytest.mark.parametrize("F,bins,C", [(7, 512, 2), (28, 8, 4), (3, 34, 5),
                                      (6, 33, 2)])
def test_pack_mat_pads_for_k4(F, bins, C):
    """K4's operands: each buffer's storage padded to 4 floats (16-byte bulk
    copies) behind the views K1 reads, and past 32 edges K4's own copy of
    the edges with rows padded by +inf to a multiple of 32."""
    edges, tables, _ = _mat(F, bins, C, seed=3)
    mat = tml.pack_mat(edges, tables)
    np.testing.assert_array_equal(mat.edges.numpy(), edges)
    np.testing.assert_array_equal(mat.tables.numpy(), tables)
    for t in (mat.edges, mat.tables, mat.k4_edges):
        assert t.is_contiguous()
        assert t.untyped_storage().nbytes() % 16 == 0
        assert t.untyped_storage().nbytes() >= 4 * t.numel()
    E = bins - 1
    if E > tml.ops.SPLIT_EDGES:
        assert mat.k4_edges.shape == (F, -(-E // 32) * 32)
        np.testing.assert_array_equal(mat.k4_edges[:, :E].numpy(), edges)
        assert bool(torch.isinf(mat.k4_edges[:, E:]).all())
    else:
        assert mat.k4_edges is mat.edges


@pytest.mark.parametrize("shape,reason", [
    ((65, 8, 2), "features"),
    ((4, 1025, 2), "bins"),
    ((4, 8, 129), "classes"),
    ((64, 128, 8), "shared memory"),
])
def test_pack_mat_refuses_outside_the_envelope(shape, reason):
    """The envelope and operand checks run once, at packing: K4's wrapper
    checks only the rows."""
    F, bins, C = shape
    edges, tables, _ = _mat(F, bins, C, seed=1)
    with pytest.raises(ValueError, match=reason):
        tml.pack_mat(edges, tables)
    with pytest.raises(ValueError, match="do not fit"):
        tml.pack_mat(edges[:2], tables[:3])


# ------------------------------------------- K1's "mat" suffix (fused)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("use_min", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_fused_mat_suffix_matches_pallas(pattern, use_min):
    stages = mat_stages(W, use_min=use_min)
    sfx = ("mat", stages[0].edges, stages[1].tables, stages[3].table,
           use_min)
    jsp, jarr = jpb._pack_suffix(sfx, 8, True)
    jtp = jff.TablePlan(2, 2, 2, 0.125, W, "all")
    ttp = tff.TablePlan(2, 2, 2, 0.125, W, "all")
    mat = tml.pack_mat(stages[0].edges, stages[1].tables, stages[3].table,
                       use_min=use_min)
    jk = jnp.full((64,), -1, jnp.int32)
    jr = jnp.zeros((64, W), jnp.float32)
    tk, tr = _t(np.asarray(jk)), _t(np.asarray(jr))
    for step in range(2):
        b = flow_batch(SPEC, pattern, 128, seed=step + 11, ragged=step == 1)
        jk, jr, jv = jff.fused_flow_serve(
            [(jk, jr, b["pkt_keys"], b["upd"], b["bins"])], b["valid"],
            (jtp,), jsp, jarr)
        tk, tr, tv = tff.fused_flow_serve(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), ttp, tff.SuffixPlan("mat", 4), mat)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                      np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_converted_mat_stages_round_trip():
    stages = mat_stages(W)
    jstages = [js.Quantize(stages[0].edges), js.LUTGather(stages[1].tables),
               js.Reduce("argmin"), js.LabelMap(stages[3].table)]
    back = convert.stages_from_reference(jstages)
    assert [s.kind for s in back] == ["quantize", "lut_gather", "reduce",
                                      "label_map"]
    np.testing.assert_array_equal(back[0].edges, stages[0].edges)
    assert back[2].op == "argmin"
