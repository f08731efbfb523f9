"""Port parity: the decomposition K1 and K2 walk their slot chains by.

The kernels (``kernels/csrc/flow_chain.cuh``, ``mitigate_chain.cuh``)
fold every packet's terms before the walk, take eviction flags from
adjacent keys and stage a chain 32 packets at a time, carrying the last
key across each chunk's edge.  Their plain forms,
``flow_update.ref.flow_update_staged_ref`` and
``fused_flow.mitigate_ref.mitigate_update_staged``, are held here bit for
bit, raw bits included, against the sequential walks
(``flow_update_ref``, ``mitigate_update``) and the JAX package's
``flow_update`` (its Pallas kernel in interpret mode on the CPU) and
``mitigate_update``: every collision pattern of ``repro_torch.testing``,
ragged batches, the chunk-edge patterns (chains of 1, 31, 32, 33, 64 and
512 packets, evictions at a chunk's first packet), ``-0.0`` increments
and rows, a table with no histograms, the 246-word row, bins that hit a
counter column or one column twice, and other chunk lengths.  Then the
whole fused function on the chunk-edge patterns: the JAX fused launch
(MAT suffix, with and without the action table) against the port's plain
version and against the decomposition composed stage by stage."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pallas_backend as jpb  # noqa: E402
from repro.flowstate import mitigation as jmit  # noqa: E402
from repro.kernels import flow_update as jfu  # noqa: E402
from repro.kernels import fused_flow as jff  # noqa: E402

from repro_torch.flowstate.registers import FlowStateSpec  # noqa: E402
from repro_torch.kernels import fused_flow as tff  # noqa: E402
from repro_torch.kernels import mat_lut as tml  # noqa: E402
from repro_torch.kernels.flow_update.ref import (  # noqa: E402
    flow_update_ref,
    flow_update_staged_ref,
)
from repro_torch.kernels.fused_flow.mitigate_ref import (  # noqa: E402
    MitigationSpec,
    mitigate_update,
    mitigate_update_staged,
)
from repro_torch.testing import (  # noqa: E402
    EDGE_PATTERNS,
    PATTERNS,
    flow_batch,
    mat_stages,
)

N_SLOTS, B = 64, 256
SPEC = FlowStateSpec(n_slots=N_SLOTS, n_counters=2, n_ewma=2,
                     hist_sizes=(16, 8), ewma_alpha=0.125)
WIDE = FlowStateSpec(n_slots=N_SLOTS, n_counters=3, n_ewma=3,
                     hist_sizes=(100, 90, 50), ewma_alpha=0.5)
BARE = FlowStateSpec(n_slots=N_SLOTS, n_counters=2, n_ewma=1,
                     hist_sizes=(), ewma_alpha=0.25)


def _t(a):
    return torch.as_tensor(np.array(a))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _kw(spec):
    return dict(n_counters=spec.n_counters, n_ewma=spec.n_ewma,
                alpha=spec.ewma_alpha)


def _empty(spec):
    return (torch.full((spec.n_slots,), -1, dtype=torch.int32),
            torch.zeros((spec.n_slots, spec.width)))


def _ops(b):
    return [_t(b[k]) for k in ("pkt_keys", "upd", "bins", "valid")]


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _chained(spec, batches, with_jax=True, chunk=None):
    """Feed the batches through the staged walk, the sequential walk and
    (with_jax) the JAX kernel, each from the table it left; all three
    equal bit for bit after every batch."""
    tk, tr = _empty(spec)
    jk = jnp.asarray(tk.numpy())
    jr = jnp.asarray(tr.numpy())
    for b in batches:
        ops = _ops(b)
        want = flow_update_ref(tk, tr, *ops, **_kw(spec))
        got = flow_update_staged_ref(tk, tr, *ops, **_kw(spec), chunk=chunk)
        _same(got, want)
        if with_jax:
            jk, jr, jf = jfu.flow_update(
                jk, jr, b["pkt_keys"], b["upd"], b["bins"], b["valid"],
                **_kw(spec))
            _same(got, (jk, jr, jf))
        tk, tr = want[0], want[1]
    return tk


@pytest.mark.parametrize("pattern,ragged",
                         [(p, r) for p in PATTERNS for r in (False, True)]
                         + [(p, False) for p in EDGE_PATTERNS])
def test_staged_walk_matches_references(pattern, ragged):
    """Two chained batches: keys', regs' and feats equal bit for bit."""
    tk = _chained(SPEC, [flow_batch(SPEC, pattern, B, seed=10 * s + 1,
                                    ragged=ragged) for s in range(2)])
    assert int((tk >= 0).sum()) > 0


@pytest.mark.parametrize("length", [1, 31, 32, 33, 64, 512])
def test_staged_walk_chain_lengths(length):
    """One slot chain of exactly ``length`` packets (evictions at packets
    32 and 40 where the chain reaches them), continuing the chain a batch
    of the same keys left, so the first chunk starts from a stored row."""
    _chained(SPEC, [flow_batch(SPEC, "one_chain", length, seed=s)
                    for s in (3, 4)])


@pytest.mark.parametrize("chunk", [1, 2, 7, 31, 33, 64])
def test_staged_walk_any_chunk_length(chunk):
    """The chunk length changes no bit: other chunk lengths than the
    kernels' 32 (a row wider than 32 words of operands stages fewer),
    three chained batches of each chunk-edge pattern."""
    for pattern in EDGE_PATTERNS:
        _chained(SPEC, [flow_batch(SPEC, pattern, B, seed=20 + s)
                        for s in range(3)], with_jax=False, chunk=chunk)


def test_staged_walk_no_histograms():
    """A table with no histograms: one bins column of -1 (``_as_bins``),
    so every column still takes its + 0.0."""
    batches = [flow_batch(BARE, p, B, seed=5, ragged=True)
               for p in ("mixed", "chain_edges")]
    assert all(b["bins"].shape[1] == 1 and (b["bins"] == -1).all()
               for b in batches)
    _chained(BARE, batches)


def test_staged_walk_wide_row():
    """A 246-word row (8 columns per lane in the kernels)."""
    _chained(WIDE, [flow_batch(WIDE, p, B, seed=6, ragged=p == "mixed")
                    for p in ("mixed", "chain_edges", "one_chain")])


def test_staged_walk_signed_zeros():
    """-0.0 in the stored rows and in every increment and EWMA value: the
    + 0.0 the histogram columns add, folded into the terms, still turns
    each -0.0 the walk produces into +0.0 where the sequential walk
    does."""
    b = flow_batch(SPEC, "chain_edges", B, seed=8)
    b["upd"] = np.where(np.random.default_rng(8).random(b["upd"].shape)
                        < 0.5, np.float32(-0.0), np.float32(0.0))
    tk, tr = _empty(SPEC)
    ops = _ops(b)
    keys, regs, _ = flow_update_ref(tk, tr, *ops, **_kw(SPEC))
    regs = torch.where(regs == 0, torch.tensor(-0.0), regs)
    want = flow_update_ref(keys, regs, *ops, **_kw(SPEC))
    _same(flow_update_staged_ref(keys, regs, *ops, **_kw(SPEC)), want)
    jout = jfu.flow_update(jnp.asarray(keys.numpy()),
                           jnp.asarray(regs.numpy()), b["pkt_keys"],
                           b["upd"], b["bins"], b["valid"], **_kw(SPEC))
    _same(want, jout)
    assert (_bits(want[2]) == _bits(np.float32(-0.0))).sum() == 0 and \
        (want[2].numpy() == 0).any()


def test_staged_walk_bins_on_counter_columns():
    """Bins that hit a counter or EWMA column, or one column twice: the
    + 1.0 adds that follow the counter's own add stay on the chain in
    the walk's order.  Rows at 2^24, where (r + u) + 1 and r + (u + 1)
    round apart, show the order."""
    b = flow_batch(SPEC, "chain_edges", B, seed=9)
    rng = np.random.default_rng(9)
    odd = rng.random(B) < 0.3                    # a counter or EWMA
    b["bins"][odd, 0] = rng.integers(0, SPEC.n_counters + SPEC.n_ewma,
                                     odd.sum())
    dup = rng.random(B) < 0.3                    # one column twice
    b["bins"][dup, 1] = b["bins"][dup, 0]
    tk, tr = _empty(SPEC)
    ops = _ops(b)
    keys, _, _ = flow_update_ref(tk, tr, *ops, **_kw(SPEC))
    regs = torch.full((N_SLOTS, SPEC.width), float(2 ** 24))
    want = flow_update_ref(keys, regs, *ops, **_kw(SPEC))
    for chunk in (None, 5):
        _same(flow_update_staged_ref(keys, regs, *ops, **_kw(SPEC),
                                     chunk=chunk), want)


# ------------------------------------------------ the action table


def _mit_batches(pattern, mit_slots, n=3):
    rng = np.random.default_rng(mit_slots)
    out = []
    for step in range(n):
        b = flow_batch(SPEC, pattern, B, seed=40 + step, ragged=step == 1,
                       key_slots=max(N_SLOTS, mit_slots))
        b["verdicts"] = (rng.random(B) < 0.7).astype(np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("pattern", ["slot_runs", "one_hot_flow",
                                     "chain_edges", "one_chain"])
@pytest.mark.parametrize("mit_slots", [64, 128])
@pytest.mark.parametrize("mode", ["drop", "rate_limit"])
def test_staged_mitigation_matches_walk(mode, mit_slots, pattern):
    """Three chained batches (the second ragged): action keys, rows and
    verdicts of the chunked walk equal the sequential walk's and the JAX
    package's, MITIGATED included."""
    spec = MitigationSpec(n_slots=mit_slots, mode=mode, threshold=3,
                          keep_every=3)
    jspec = jmit.MitigationSpec(n_slots=mit_slots, mode=mode, threshold=3,
                                keep_every=3)
    tk = torch.full((mit_slots,), -1, dtype=torch.int32)
    tr = torch.zeros((mit_slots, 2))
    jk, jr = jmit.init_mitigation(jspec)
    dropped = 0
    for b in _mit_batches(pattern, mit_slots):
        args = (_t(b["pkt_keys"]), _t(b["verdicts"]), _t(b["valid"]))
        want = mitigate_update(tk, tr, *args, spec=spec)
        _same(mitigate_update_staged(tk, tr, *args, spec=spec), want)
        jk, jr, jv = jmit.mitigate_update(jk, jr, b["pkt_keys"],
                                          b["verdicts"], b["valid"],
                                          spec=jspec)
        _same(want, (jk, jr, jv))
        dropped += int((want[2] == tff.MITIGATED).sum())
        tk, tr = want[0], want[1]
    assert dropped > 0


@pytest.mark.parametrize("chunk", [1, 5, 33])
def test_staged_mitigation_any_chunk_length(chunk):
    for pattern in EDGE_PATTERNS:
        spec = MitigationSpec(n_slots=N_SLOTS, mode="rate_limit",
                              threshold=2, keep_every=3)
        tk = torch.full((N_SLOTS,), -1, dtype=torch.int32)
        tr = torch.zeros((N_SLOTS, 2))
        for b in _mit_batches(pattern, N_SLOTS):
            args = (_t(b["pkt_keys"]), _t(b["verdicts"]), _t(b["valid"]))
            want = mitigate_update(tk, tr, *args, spec=spec)
            _same(mitigate_update_staged(tk, tr, *args, spec=spec,
                                         chunk=chunk), want)
            tk, tr = want[0], want[1]


# ------------------------------------------------ the fused function


@pytest.mark.parametrize("pattern", EDGE_PATTERNS)
@pytest.mark.parametrize("mit_slots", [None, 64, 128])
def test_fused_edges_match_pallas_and_decomposition(pattern, mit_slots):
    """K1's function with a MAT suffix (exact scores) on the chunk-edge
    patterns, three chained batches: the JAX fused launch (Pallas, in
    interpret mode), the port's plain version and the decomposition —
    the staged walk, the readout, the MAT and the chunked action walk —
    agree on every table and verdict, bit for bit."""
    W = SPEC.width
    stages = mat_stages(W)
    jsp, jarr = jpb._pack_suffix(("mat", stages[0].edges, stages[1].tables,
                                  stages[3].table, False), 8, True)
    mat = tml.pack_mat(stages[0].edges, stages[1].tables, stages[3].table)
    tp = tff.TablePlan(2, 2, 2, 0.125, W, "all")
    jtp = jff.TablePlan(2, 2, 2, 0.125, W, "all")
    sp = tff.SuffixPlan("mat", 4)
    jk, jr = jnp.full((N_SLOTS,), -1, jnp.int32), \
        jnp.zeros((N_SLOTS, W), jnp.float32)
    tk, tr = _empty(SPEC)
    mit = jmit_state = None
    if mit_slots is not None:
        mspec = MitigationSpec(n_slots=mit_slots, mode="rate_limit",
                               threshold=3, keep_every=3)
        jspec = jmit.MitigationSpec(n_slots=mit_slots, mode="rate_limit",
                                    threshold=3, keep_every=3)
        mit = (torch.full((mit_slots,), -1, dtype=torch.int32),
               torch.zeros((mit_slots, 2)), mspec)
        jmit_state = jmit.init_mitigation(jspec)
    for step in range(3):
        b = flow_batch(SPEC, pattern, B, seed=60 + step,
                       key_slots=max(N_SLOTS, mit_slots or 0))
        ops = _ops(b)
        got = tff.fused_flow_serve(tk, tr, *ops, tp, sp, mat, mit)
        jout = jff.fused_flow_serve(
            [(jk, jr, b["pkt_keys"], b["upd"], b["bins"])], b["valid"],
            (jtp,), jsp, jarr, **({} if mit is None else
                                 {"mitigation": (*jmit_state, jspec)}))
        _same(got, jout)
        # the decomposition, stage by stage
        k2, r2, feats = flow_update_staged_ref(tk, tr, *ops, **_kw(SPEC))
        v = tml.mat_classify_ref(tff.suffix_readout(feats, tp), mat.edges,
                                 mat.tables, mat.lmap)
        dec = [k2, r2]
        if mit is not None:
            mk, mr, v = mitigate_update_staged(mit[0], mit[1], ops[0], v,
                                               ops[3], spec=mit[2])
            dec += [mk, mr]
            mit = (got[2], got[3], mit[2])
            jmit_state = (jout[2], jout[3])
        _same(dec + [v], got)
        tk, tr = got[0], got[1]
        jk, jr = jout[0], jout[1]
