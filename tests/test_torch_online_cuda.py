"""The online loop's hand-off under two retrain episodes, served while
batches stay in flight.  Each episode builds its pipeline on a
``BackgroundRetrainer`` worker (on the card: on the worker's own CUDA
stream, its tensors allocated there) and parks it with ``engine.swap``;
the serving thread installs it at a ring boundary with earlier batches
still in flight (depth 2), the second install retiring the first
episode's pipeline.  The pipelines end in the flow-ddos MAT
(``testing.mat_stages``), whose verdicts K1 gives exactly, so the served
stream is held bit for bit against a CPU engine (plain versions) that
installs the same pipelines at the same packet offsets: verdicts and
tables equal.

Imports nothing of the JAX package, so it runs where only the port is
installed: ``python -m pytest -q tests/test_torch_online_cuda.py``.  The
card case skips without a GPU; the CPU case runs the same sequence with
both engines on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import traffic  # noqa: E402
from repro_torch.flowstate import StatefulPipeline  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BackgroundRetrainer,
    PacketServeEngine,
)
from repro_torch.testing import mat_stages  # noqa: E402

N_SLOTS, B, N_PACKETS = 1024, 512, 16_384


def _stages(seed):
    (fk, ru, ws), _ = traffic.flow_feature_stages(n_slots=N_SLOTS)
    return [fk, ru, ws, *mat_stages(ws.n_out, seed=seed)]


def _pipeline(seed, device):
    return StatefulPipeline(_stages(seed), backend="cuda", device=device)


def _engine(device):
    return PacketServeEngine(_pipeline(7, device),
                             feature_dim=len(traffic.COLUMNS),
                             max_batch=B, depth=2, device=device)


def _two_episodes(device):
    stream = traffic.make_stream("ddos_burst", n_packets=N_PACKETS, seed=3)
    chunks = list(stream.chunks(B))
    eng = _engine(device)
    workers = []

    def episode(seed):
        def fn(windows):
            if device == "cuda":        # scratch on the worker's stream
                torch.empty(1 << 20, device=device).fill_(float("nan"))
            return _pipeline(seed, device)
        workers.append(BackgroundRetrainer(eng, fn, []).start())

    def feed():
        """The stream, starting episode 1 a quarter in and episode 2 once
        episode 1 has installed (so neither park replaces the other)."""
        for i, c in enumerate(chunks):
            if i == len(chunks) // 4:
                episode(1)
            if len(workers) == 1 and eng.stats_.swaps == 1:
                episode(2)
            if len(workers) == 1 and i == len(chunks) - 8:
                workers[0].join(120)     # ep 1 installs before the end
            if len(workers) == 2 and i == len(chunks) - 3:
                workers[1].join(120)     # ep 2 parks before the tail
            yield c

    verdicts = np.concatenate(list(eng.serve_stream(feed())))
    eng.flush()
    assert [w.error for w in workers] == [None, None]
    offsets = eng.stats()["swap_pkt_offsets"]
    assert len(offsets) == 2 and offsets[0] < offsets[1] < N_PACKETS
    kinds = [e["kind"] for e in eng.telemetry().journal.events()]
    assert kinds.count("hot_swap") == 2

    # the CPU twin: the same pipelines installed at the same offsets
    twin = _engine("cpu")
    want = []
    todo = list(zip(offsets, (1, 2)))
    for lo in range(0, N_PACKETS, B):
        if todo and todo[0][0] == lo:
            twin.swap(_pipeline(todo.pop(0)[1], "cpu"))
        twin.submit(stream.packets[lo:lo + B])
        want.append(twin.flush())
    assert not todo and twin.stats_.swaps == 2
    np.testing.assert_array_equal(verdicts, np.concatenate(want))
    for a, b in ((eng.state.keys, twin.state.keys),
                 (eng.state.regs, twin.state.regs)):
        assert torch.equal(a.cpu().view(torch.int32),
                           b.view(torch.int32))


def test_two_episodes_hand_off_on_the_cpu():
    _two_episodes("cpu")


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA GPU: the worker's own stream and "
                    "the install's event wait exist only on the card")
def test_two_episodes_hand_off_on_the_card():
    _two_episodes("cuda")
