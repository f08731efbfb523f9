"""Fault tolerance (counterpart of ``repro.ft.restart``): restart
manager + straggler watchdog, on the port's checkpointer.

RestartManager wraps a training loop: it checkpoints every N steps and, on
crash/restart, resumes from the latest complete checkpoint with the exact
data stream position (stateless TokenDataset.batch_at(step)).  On the CPU
a resumed run is bit for bit the uninterrupted one
(tests/test_torch_ckpt.py); on the card the embedding's backward
accumulates with atomics, so a resumed run agrees within rounding.

StragglerWatchdog tracks per-step wall times; a step slower than
``threshold x`` the running median is flagged and handed to
``on_straggler``.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []
        self.on_straggler: Callable[[int, float], None] | None = None

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt / med)
                return True
        return False


class RestartManager:
    def __init__(self, ckpt_dir: str, *, save_every: int = 50,
                 keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep)
        self.watchdog = StragglerWatchdog()

    def maybe_restore(self, state, device=None):
        """Resume from the latest checkpoint if one exists -> (state,
        step); the leaves land on ``state``'s devices or on ``device``."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return state, 0
        return restore_checkpoint(self.ckpt_dir, state, step, device=device)

    def run(self, state, step_fn, batch_fn, *, num_steps: int,
            start_step: int = 0, metrics_cb=None):
        """Drive the train loop with periodic async checkpoints."""
        step = start_step
        while step < num_steps:
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            step += 1
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            if step % self.save_every == 0 or step == num_steps:
                self.ckpt.save(state, step)
        self.ckpt.wait()
        return state, step
