"""The launchers (``repro_torch.launch.train`` / ``serve``) on the CPU
against the JAX package's, on the reference's seeded weights carried
across (``convert``): the per-step losses of a 3-step run against the
reference's jitted ``make_train_step`` on the same ``TokenDataset``
batches (within 2e-3 relative, ``test_torch_train_loop.py``'s
microbatch bound: the same bf16 function summed in another order); a
``--ckpt-dir`` run stopped after step 2's checkpoint and resumed, bit for
bit the uninterrupted run; served tokens against the reference's
``ServeEngine``; every architecture's smoke config through both
launchers; ``--mesh`` raising with its reason."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.tokens import TokenDataset as JaxTokens
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.step import TrainSettings as JaxSettings
from repro.train.step import cast_for_compute as jax_cast
from repro.train.step import init_train_state as jax_init
from repro.train.step import make_train_step as jax_make_step
from repro_torch import convert
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.train import cast_for_compute

ARCH = "qwen3-1.7b"
STEPS, BATCH, SEQ = 3, 2, 32
TRAIN_ARGS = ["--arch", ARCH, "--device", "cpu", "--steps", str(STEPS),
              "--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1"]
# two lockstep batches of two
REQUESTS, PROMPT, NEW, SLOTS, MAX_SEQ = 4, 8, 4, 2, 32
SERVE_ARGS = ["--arch", ARCH, "--device", "cpu", "--requests", str(REQUESTS),
              "--prompt-len", str(PROMPT), "--max-new", str(NEW),
              "--slots", str(SLOTS), "--max-seq", str(MAX_SEQ)]


@pytest.fixture(scope="module")
def reference_state():
    """The reference's ``init_train_state(cfg, PRNGKey(0))``, numpy
    leaves (drawn once for the module)."""
    return jax.tree.map(np.asarray,
                        jax_init(jax_smoke(ARCH), jax.random.PRNGKey(0)))


def _train(argv, reference_state):
    losses = []
    out = launch_train.main(
        argv, state=convert.train_state_from_reference(reference_state,
                                                       device="cpu"),
        on_step=lambda s, m: losses.append((s, float(m["loss"]))))
    return out, losses


@pytest.fixture(scope="module")
def reference_losses():
    """The reference launcher's loop: its settings for these flags and its
    jitted, donating step over ``TokenDataset(seed=0)``."""
    cfg = jax_smoke(ARCH)
    settings = JaxSettings(microbatches=1, peak_lr=3e-3, warmup=5,
                           total_steps=STEPS, remat=True)
    step = jax.jit(jax_make_step(cfg, settings), donate_argnums=(0,))
    state = jax_init(cfg, jax.random.PRNGKey(0))
    data = JaxTokens(cfg.vocab_size, SEQ, BATCH, seed=0)
    losses = []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch_at(i).items()})
        losses.append(float(m["loss"]))
    return losses


def test_train_launcher_follows_the_reference(reference_losses,
                                              reference_state, capsys):
    out, losses = _train(TRAIN_ARGS, reference_state)
    assert set(out) == {"arch", "steps", "first_loss", "final_loss",
                        "wall_s"}
    assert out["arch"] == jax_smoke(ARCH).name and out["steps"] == STEPS
    assert [s for s, _ in losses] == [1, 2, 3]
    for (_, got), want in zip(losses, reference_losses):
        assert abs(got - want) <= 2e-3 * abs(want), (losses,
                                                     reference_losses)
    assert (out["first_loss"], out["final_loss"]) == (losses[0][1],
                                                      losses[-1][1])
    log = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in log[:STEPS]] == [
        ["step", str(i)] for i in (1, 2, 3)]


def _manifest(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:010d}",
                           "manifest.json")) as f:
        return [(m["path"], m["crc32"]) for m in json.load(f)["leaves"]]


def test_train_launcher_restart_replays_bit_for_bit(tmp_path, capsys,
                                                    reference_state):
    """Run 3 steps checkpointing at 2 and 3, drop step 3's checkpoint (a
    crash after step 2's), and run again: it resumes at step 2 and its
    step 3 (loss and the whole saved state) is the first run's."""
    d = str(tmp_path / "ckpt")
    argv = TRAIN_ARGS + ["--ckpt-dir", d, "--save-every", "2"]
    _, first = _train(argv, reference_state)
    whole = _manifest(d, 3)
    shutil.rmtree(os.path.join(d, f"step_{3:010d}"))
    capsys.readouterr()
    _, resumed = _train(argv, reference_state)
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    assert resumed == first[2:]
    assert _manifest(d, 3) == whole


def test_serve_launcher_serves_the_references_tokens(reference_state):
    """The launcher serves in bf16.  The reference's engine is run op by
    op (``jax.disable_jit``: every op rounded to bf16, as the port's eager
    ops are), where the port's bf16 forward on a silu config is bit for
    bit the reference's (``test_torch_lm.py``); jitted, XLA keeps f32
    between fused ops, and the seeded model's near-tied logits then pick
    other tokens in either package."""
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(0)
    jreqs = [JaxRequest(rid, rng.integers(0, cfg.vocab_size, size=PROMPT
                                          ).astype(np.int32),
                        max_new_tokens=NEW) for rid in range(REQUESTS)]
    with jax.disable_jit():
        jeng = JaxServeEngine(
            cfg, jax_cast(jax.tree.map(jnp.asarray,
                                       reference_state["params"])),
            batch_slots=SLOTS, max_seq=MAX_SEQ)
        for r in jreqs:
            jeng.submit(r)
        jstats = jeng.run(max_steps=REQUESTS * NEW + 64)

    carried = convert.train_state_from_reference(reference_state,
                                                 device="cpu")
    served = []
    stats = launch_serve.main(SERVE_ARGS,
                              params=cast_for_compute(carried["params"]),
                              requests_out=served)
    assert set(stats) == set(jstats)
    assert (stats["requests"], stats["tokens"]) == (
        REQUESTS, REQUESTS * NEW) == (jstats["requests"], jstats["tokens"])
    for a, b in zip(served, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.done and a.out == b.out, (a.rid, a.out, b.out)


@pytest.mark.parametrize("mesh", ("pod", "multipod"))
def test_mesh_raises_with_its_reason(mesh):
    for main, argv in ((launch_train.main, TRAIN_ARGS),
                       (launch_serve.main, SERVE_ARGS)):
        with pytest.raises(NotImplementedError,
                           match=f"--mesh {mesh}: .*shard annotations"):
            main(argv + ["--mesh", mesh])


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its shapes are tiny, and with
    the suite's workers sharing the cores a thread pool a worker spends
    most of its time waiting on the others (the Jamba case took 70 s so,
    3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_runs_through_both_launchers(arch, one_thread):
    """Each architecture's smoke config through both launchers on the CPU
    (the encdec config with its zero frames, the vlm one with its zero
    image embeddings): one finite training step, and every request
    served with its tokens in the vocabulary."""
    cfg = get_smoke_config(arch)
    out = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                             "1", "--batch", "2", "--seq", "64"])
    assert out["arch"] == cfg.name and np.isfinite(out["final_loss"])
    served = []
    stats = launch_serve.main(
        ["--arch", arch, "--device", "cpu", "--requests", "2", "--slots",
         "2", "--prompt-len", "8", "--max-new", "2", "--max-seq", "16"],
        requests_out=served)
    assert stats["tokens"] == 4 and len(served) == 2
    assert all(r.done and len(r.out) == 2 and 0 <= min(r.out)
               and max(r.out) < cfg.vocab_size for r in served)
