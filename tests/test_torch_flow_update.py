"""Port parity: the flow-register update and its slot segmentation.

The JAX ``kernels.flow_update.flow_update`` (Pallas kernel, interpret mode
on the CPU) against the port's ``flow_update`` on CPU tensors (its plain
version), over the collision patterns of ``repro_torch.testing``: one hot
flow, all distinct keys, same-slot eviction chains and ragged ``valid``.
Keys, register rows and feature rows must match bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import stageir as jstageir  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.flowstate import FlowStateSpec as JSpec  # noqa: E402
from repro.kernels import flow_update as jfu  # noqa: E402
from repro.kernels.flow_update.ops import segment_batch as jsegment  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.flowstate.registers import FlowStateSpec, hash_slot_np  # noqa: E402
from repro_torch.kernels import flow_update as tfu  # noqa: E402
from repro_torch.testing import PATTERNS, flow_batch  # noqa: E402

N_SLOTS, B = 64, 256
SPEC = FlowStateSpec(n_slots=N_SLOTS, n_counters=2, n_ewma=2,
                     hist_sizes=(16, 8), ewma_alpha=0.125)
CASES = [(p, r) for p in PATTERNS for r in (False, True)]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("pattern,ragged", CASES)
def test_flow_update_matches_reference(pattern, ragged):
    """Two chained batches (the second sees the first's table) through
    both packages: keys', regs' and feats equal bit for bit."""
    jk = jnp.full((N_SLOTS,), -1, jnp.int32)
    jr = jnp.zeros((N_SLOTS, SPEC.width), jnp.float32)
    tk, tr = _t(np.asarray(jk)), _t(np.asarray(jr))
    for step in range(2):
        b = flow_batch(SPEC, pattern, B, seed=10 * step + 1, ragged=ragged)
        jk, jr, jf = jfu.flow_update(
            jk, jr, b["pkt_keys"], b["upd"], b["bins"], b["valid"],
            n_counters=2, n_ewma=2, alpha=0.125)
        tk, tr, tf = tfu.flow_update(
            tk, tr, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
            _t(b["valid"]), n_counters=2, n_ewma=2, alpha=0.125)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        # sign of zero included: compare the raw bits
        np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                      np.asarray(jf).view(np.int32))
        np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                      np.asarray(jr).view(np.int32))
    assert int((tk >= 0).sum()) > 0


def test_flow_update_wide_row_matches_reference():
    """A 246-word row (8 columns per lane in the kernels) with three
    counters, three EWMAs and three histograms."""
    spec = FlowStateSpec(n_slots=N_SLOTS, n_counters=3, n_ewma=3,
                         hist_sizes=(100, 90, 50), ewma_alpha=0.5)
    b = flow_batch(spec, "mixed", B, seed=5, ragged=True)
    jk = jnp.full((N_SLOTS,), -1, jnp.int32)
    jr = jnp.zeros((N_SLOTS, spec.width), jnp.float32)
    jk, jr, jf = jfu.flow_update(
        jk, jr, b["pkt_keys"], b["upd"], b["bins"], b["valid"],
        n_counters=3, n_ewma=3, alpha=0.5)
    tk, tr, tf = tfu.flow_update(
        torch.full((N_SLOTS,), -1, dtype=torch.int32),
        torch.zeros((N_SLOTS, spec.width)),
        _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]), _t(b["valid"]),
        n_counters=3, n_ewma=3, alpha=0.5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                  np.asarray(jr).view(np.int32))
    np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                  np.asarray(jf).view(np.int32))


@pytest.mark.parametrize("pattern,ragged", CASES)
def test_segment_batch_matches_reference(pattern, ragged):
    b = flow_batch(SPEC, pattern, B, seed=3, ragged=ragged)
    slot = hash_slot_np(b["pkt_keys"], N_SLOTS)
    js = jsegment(jnp.asarray(slot), jnp.asarray(b["valid"]), N_SLOTS)
    ts = tfu.segment_batch(_t(slot), _t(b["valid"]), N_SLOTS)
    for field in tfu.Segments._fields:
        np.testing.assert_array_equal(
            getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
            err_msg=field)


def test_hash_slot_matches_reference():
    keys = np.concatenate([
        np.array([-1, 0, 1, 2**31 - 1, -2**31], np.int32),
        np.random.default_rng(0).integers(-2**31, 2**31 - 1, 4096,
                                          dtype=np.int64).astype(np.int32),
    ])
    for n_slots in (2, 64, 1 << 16):
        want = np.asarray(jfu.hash_slot(jnp.asarray(keys), n_slots))
        np.testing.assert_array_equal(
            tfu.hash_slot(_t(keys), n_slots).numpy(), want)
        np.testing.assert_array_equal(hash_slot_np(keys, n_slots), want)


def test_flow_key_and_prepare_match_reference():
    """FlowKey.apply_keys and RegisterUpdate.prepare on a real stream,
    plus half-way rounding and negative header values."""
    (fk, ru, _), _ = jtraffic.flow_feature_stages(n_slots=N_SLOTS)
    pfk, pru = convert.stages_from_reference([fk, ru])
    x = jtraffic.make_stream("ddos_burst", n_packets=512, seed=1).packets
    x = x.copy()
    x[:8, 0] = [0.5, 1.5, 2.5, -0.5, -3.5, 7.49, 1e6, -1e6]
    np.testing.assert_array_equal(pfk.apply_keys(_t(x)).numpy(),
                                  np.asarray(fk.apply_keys(jnp.asarray(x))))
    ju, jb = ru.prepare(jnp.asarray(x))
    tu, tb = pru.prepare(_t(x))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kwargs", [
    {"n_slots": 48}, {"n_slots": 1}, {"n_counters": 0},
    {"hist_sizes": (4, 0)}, {"n_ewma": 1, "ewma_alpha": 0.3},
    {"n_ewma": 1, "ewma_alpha": 1.0},
])
def test_spec_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        JSpec(**kwargs)
    with pytest.raises(ValueError):
        FlowStateSpec(**kwargs)


def test_spec_layout_matches_reference():
    j = JSpec(n_slots=64, n_counters=2, n_ewma=2, hist_sizes=(16, 8))
    t = convert.spec_from_reference(j)
    assert (t.width, t.hist_offsets, t.sram_bytes) \
        == (j.width, j.hist_offsets, j.sram_bytes)


def test_launch_wrapper_refuses_cpu_tensors_and_oversized_tables():
    """The CUDA wrapper never runs the plain version: CPU tensors and
    tables outside the envelope raise."""
    b = flow_batch(SPEC, "mixed", 8, seed=0)
    keys = torch.full((N_SLOTS,), -1, dtype=torch.int32)
    regs = torch.zeros((N_SLOTS, SPEC.width))
    *ops, seg = tfu.ops.prepare_operands(
        keys, regs, _t(b["pkt_keys"]), _t(b["upd"]), _t(b["bins"]),
        _t(b["valid"]))
    with pytest.raises(ValueError, match="CUDA"):
        tfu.flow_update_launch(*ops, seg, n_counters=2, n_ewma=2,
                               alpha=0.125)
    big = torch.zeros((2 * tfu.MAX_SLOTS, SPEC.width))
    with pytest.raises(ValueError, match="MAX_SLOTS"):
        tfu.ops.check_operands(
            torch.zeros(2 * tfu.MAX_SLOTS, dtype=torch.int32), big,
            *ops[2:], n_counters=2, n_ewma=2)


def test_stages_from_reference_rejects_unported_kinds():
    # every stage kind of the reference converts now (TreeTraverse last);
    # a kind the port does not know is still refused by name
    tree = jstageir.TreeTraverse.from_nodes([{"leaf": 0}], depth=1)
    assert convert.stages_from_reference([tree])[0].kind == "tree_traverse"

    class Unknown(jstageir.Stage):
        kind = "binarized_dense"

    with pytest.raises(NotImplementedError, match="binarized_dense"):
        convert.stages_from_reference([Unknown()])
