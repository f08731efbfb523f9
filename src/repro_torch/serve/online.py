"""The online-learning loop: drift -> background retrain -> hot swap
(counterpart of ``repro.serve.online``).

Closes the redeployment loop around the serving engine
(docs/pipeline_ir.md#hot-swap-contract): ``HotSwapController`` watches
every submitted packet window with a ``flowstate.drift.DriftDetector``,
and when drift fires hands the recent windows to a
``BackgroundRetrainer`` — a worker thread that builds a new pipeline
(typically ``core.dse.retrain_model`` over features re-extracted from the
drifted windows by ``data.traffic.stream_feature_dataset``, warm-started
by ``core.traincache.GLOBAL_CACHE``) and parks it on the engine with
``engine.swap``.  The foreground thread keeps submitting and flushing the
whole time; the swap installs at the next ring boundary the engine
crosses, so serving never pauses and no batch is dropped.

Division of labor:

  * the CONTROLLER is synchronous and cheap — one numpy EWMA update per
    window on the submit path;
  * the RETRAINER owns everything expensive — feature extraction (K2 on
    the card), dataset assembly, the DSE racer (training on the card),
    compilation, and the engine-side swap warm-up (``engine.swap``
    builds and warms the incoming pipeline on the caller's thread
    before parking it);
  * the ENGINE's dispatch path never blocks on either — it checks one
    lock-guarded pointer per ring boundary.

On the card the whole episode runs on a CUDA stream of its own, so the
worker's launches never queue behind, or in front of, the serving
thread's on the default stream; ``engine.swap`` records an event on that
stream when it parks the pipeline and the install makes the serving
stream wait on it, so no serving launch reads a weight still being
written, and the engine holds a retired pipeline until its last batch
is fetched, so its memory is not reused while the card still reads it.
The trainer's CUDA graph captures use ``capture_error_mode="thread_local"``
(``core.mlalgos``), so the serving thread's event waits and allocations
during a capture are legal.

The ``retrain_fn`` callback owns labeling policy: production systems
would label drifted windows by slow-path annotation or delayed feedback;
examples/tests use scenario ground truth.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.flowstate.drift import DriftDetector


def _episode_stream(engine):
    """A CUDA stream of the episode's own when ``engine`` serves on the
    card; no stream change elsewhere."""
    dev = getattr(engine, "device", None)
    if dev is None or dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(dev))


class BackgroundRetrainer:
    """One retrain episode on a worker thread, ending in ``engine.swap``.

    ``fn`` is called with the drifted windows (a list of [n, F] packet
    arrays) and must return the new serving pipeline; any exception is
    captured on ``error`` rather than killing the process — the engine
    then simply keeps serving the old model."""

    def __init__(self, engine, fn, windows: list, *,
                 on_done=None):
        self.engine = engine
        self.fn = fn
        self.windows = windows
        self.on_done = on_done
        self.result = None
        self.error: BaseException | None = None
        self.wall_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="hot-swap-retrain", daemon=True
        )

    def start(self) -> "BackgroundRetrainer":
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            with _episode_stream(self.engine):
                pipeline = self.fn(self.windows)
                # swap() warms/compiles HERE, on the worker thread and
                # its stream, then parks with an event on that stream;
                # the serving thread flips a pointer at the next ring
                # boundary, its stream waiting on the event
                self.engine.swap(pipeline)
            self.result = pipeline
        except BaseException as e:       # noqa: BLE001 — reported; the old
            self.error = e               # model serves on
        finally:
            self.wall_s = time.perf_counter() - t0
            if self.on_done is not None:
                self.on_done(self)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)


class HotSwapController:
    """Drift-triggered retraining glued to one serving engine.

    Call ``observe(window)`` with every packet window as (or just before)
    it is submitted to the engine; the controller folds it into the drift
    statistic, keeps the last ``buffer_windows`` windows as the retrain
    corpus, and — when the detector fires — launches ONE background
    retrain episode.  After the retrained pipeline is parked the detector
    re-arms (``reset``), so the next episode measures drift against the
    same frozen snapshot but needs a fresh patience streak.

    ``retrain_fn(windows) -> pipeline`` owns dataset assembly, labeling
    and search; see module docstring.
    """

    def __init__(self, engine, detector: DriftDetector, retrain_fn, *,
                 buffer_windows: int = 64):
        self.engine = engine
        self.detector = detector
        self.retrain_fn = retrain_fn
        self._buffer: deque = deque(maxlen=int(buffer_windows))
        self._worker: BackgroundRetrainer | None = None
        self.episodes = 0          # retrains launched
        self.swapped = 0           # retrains that ended in a parked swap
        self.errors: list[BaseException] = []

    def observe(self, window: np.ndarray) -> float:
        """Fold one packet window in; may launch a retrain.  Returns the
        current drift score (cheap enough for the submit path)."""
        score = self.detector.update(window)
        self._buffer.append(np.array(window, np.float32))
        if self.detector.fired and not self.retraining:
            self._emit("drift", score=round(float(score), 6),
                       windows=len(self._buffer))
            self._launch()
        return score

    @property
    def retraining(self) -> bool:
        return self._worker is not None and self._worker.running

    def _journal(self):
        """The engine's journal, when a telemetry plane is attached."""
        tel = getattr(self.engine, "telemetry", lambda: None)()
        return tel.journal if tel is not None else None

    def _emit(self, kind: str, **fields) -> None:
        j = self._journal()
        if j is not None:
            j.emit(kind, **fields)

    def _launch(self) -> None:
        self.episodes += 1
        self._emit("retrain_start", episode=self.episodes,
                   windows=len(self._buffer))
        self._worker = BackgroundRetrainer(
            self.engine, self.retrain_fn, list(self._buffer),
            on_done=self._finish,
        ).start()

    def _finish(self, worker: BackgroundRetrainer) -> None:
        if worker.error is not None:
            self.errors.append(worker.error)
            self._emit("retrain_done", episode=self.episodes, ok=False,
                       error=repr(worker.error),
                       wall_s=round(worker.wall_s, 3))
            return
        self.swapped += 1
        self._emit("retrain_done", episode=self.episodes, ok=True,
                   wall_s=round(worker.wall_s, 3))
        # re-arm: the NEW model gets its own drift episode
        self.detector.reset()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the in-flight retrain (if any) has parked its swap.
        Returns True when no retrain is left running.  NOTE: the swap
        still installs at the engine's next ring boundary — follow with
        ``engine.flush()`` (or more traffic) to force installation."""
        if self._worker is not None:
            self._worker.join(timeout)
        return not self.retraining

    def report(self) -> dict:
        return {
            **self.detector.report(),
            "episodes": self.episodes,
            "swapped": self.swapped,
            "retraining": self.retraining,
            "errors": [repr(e) for e in self.errors],
            "retrain_wall_s": (
                round(self._worker.wall_s, 3) if self._worker else 0.0
            ),
        }
