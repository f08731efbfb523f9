"""Checkpoints and restart (``repro_torch.ckpt``, ``repro_torch.ft``),
mirroring tests/test_checkpoint_ft.py: round trip (bf16 too), crc
detection, an incomplete step ignored, async keep-N, restart bit for bit
on the CPU, the straggler watchdog; and the port's own format: a JSON
manifest, the zlib codec, bf16 as its raw 2-byte words, restore onto a
named device."""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from repro_torch.ckpt import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenDataset
from repro_torch.ft import RestartManager, StragglerWatchdog
from repro_torch.train import TrainSettings, init_train_state, make_train_step


def _tiny_state():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.tensor([1.5, -2.25, 3e-3, 7.0, 0.1],
                                     dtype=torch.bfloat16)},
        "layers": [{"x": torch.ones(2)}, {"x": torch.zeros(2)}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    state = _tiny_state()
    d = save_checkpoint(str(tmp_path), state, 7)
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 7
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["codec"] == "zlib" and manifest["step"] == 7
    bf = [m for m in manifest["leaves"] if m["dtype"] == "bfloat16"]
    assert len(bf) == 1 and bf[0]["path"] == "nested/b"
    with open(os.path.join(d, bf[0]["file"]), "rb") as f:
        raw = zlib.decompress(f.read())
    assert raw == state["nested"]["b"].view(torch.uint16).numpy().tobytes()
    assert zlib.crc32(raw) == bf[0]["crc32"]


def test_restore_onto_a_device_and_checks_shapes(tmp_path):
    state = _tiny_state()
    save_checkpoint(str(tmp_path), state, 1)
    restored, _ = restore_checkpoint(str(tmp_path), state, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))
    bad = dict(state, w=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"w": state["w"]})


def test_crc_detects_corruption(tmp_path):
    state = _tiny_state()
    d = save_checkpoint(str(tmp_path), state, 1)
    victim = os.path.join(d, "leaf_00000.bin.zst")
    raw = zlib.decompress(open(victim, "rb").read())
    flipped = bytearray(raw)
    flipped[len(flipped) // 2] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(zlib.compress(bytes(flipped)))
    with pytest.raises(IOError, match="crc"):
        restore_checkpoint(str(tmp_path), state)


def test_latest_step_ignores_incomplete(tmp_path):
    state = _tiny_state()
    save_checkpoint(str(tmp_path), state, 5)
    os.makedirs(tmp_path / "step_0000000009")      # a crashed save
    with open(tmp_path / "latest", "w") as f:
        f.write("9")
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "nothing")) is None


def test_async_checkpointer_gc_and_host_copy(tmp_path):
    """Keep-N garbage collection; the host copy is taken at ``save``, so
    an in-place update right after it does not reach the checkpoint."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        ck.save(state, s)
        state["w"].add_(1.0)
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert latest_step(str(tmp_path)) == 4
    restored, _ = restore_checkpoint(str(tmp_path), state)
    assert torch.equal(restored["w"], state["w"] - 1.0)


def test_restart_bitwise_identical(tmp_path):
    """Train 12 steps straight vs 6 + crash + resume 6: identical params
    and moments, bit for bit (the CPU's sums run in one order)."""
    cfg = get_smoke_config("qwen3-1.7b")
    data = TokenDataset(cfg.vocab_size, 32, 4, seed=0)
    settings = TrainSettings(remat=False, warmup=2, total_steps=12)

    def fresh():
        return init_train_state(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}

    step_fn = make_train_step(cfg, settings)
    state = fresh()
    for s in range(12):
        state, _ = step_fn(state, batch_fn(s))

    d = str(tmp_path / "ck")
    mgr = RestartManager(d, save_every=3)
    st2, end = mgr.run(fresh(), step_fn, batch_fn, num_steps=6)
    assert end == 6
    del st2                                          # "crash"

    mgr2 = RestartManager(d, save_every=3)
    st3, start = mgr2.maybe_restore(fresh())
    assert start == 6 and int(st3["step"]) == 6
    st3, _ = mgr2.run(st3, step_fn, batch_fn, num_steps=12, start_step=start)
    for a, b in zip(tree_leaves(state), tree_leaves(st3)):
        assert torch.equal(a, b)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(threshold=3.0)
    hits = []
    wd.on_straggler = lambda step, ratio: hits.append((step, ratio))
    for s in range(10):
        wd.observe(s, 0.1)
    assert not wd.flagged
    wd.observe(10, 0.45)
    assert wd.flagged == [10]
    assert hits and hits[0][1] > 3.0
    assert np.isclose(hits[0][1], 4.5)
