"""Monotonic-clock span tracing with a ring-buffer sink.

Spans are recorded host-side at dispatch-ring boundaries — the stage/
dispatch/fetch phases of the serving engines — so the depth-k overlap
pipeline and every bit-identity contract stay untouched: tracing reads
``time.perf_counter()`` twice and appends ONE tuple to a bounded deque.
A long-running engine keeps O(capacity) memory; old spans fall off the
back.

Export: ``chrome_trace()`` renders the ring as Chrome ``trace_event``
JSON (the ``{"traceEvents": [...]}`` object format) — complete events
(``"ph": "X"``) with microsecond timestamps relative to the tracer's
epoch, one ``tid`` lane per recording thread — loadable in
``chrome://tracing`` / Perfetto.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager

__all__ = ["Span", "Tracer"]


class Span(collections.namedtuple(
        "Span", ["name", "cat", "t0", "dur_s", "tid", "args"])):
    """One recorded span: ``t0`` is seconds on the tracer's monotonic
    clock (``perf_counter`` minus the tracer epoch), ``dur_s`` its
    length, ``tid`` the recording thread's ident, ``args`` a small
    JSON-clean dict of annotations (backend, batch rows, …)."""

    __slots__ = ()


class Tracer:
    """Bounded span sink over the monotonic clock.

    The fast path is ``record(name, t0, t1)`` with timestamps the caller
    already holds (the engines time their dispatches anyway): one tuple
    construction + one deque append, no lock — deque.append is atomic
    under the GIL and the ring bound makes concurrent appends safe.
    ``span()`` is the convenience context manager for non-hot-path
    phases (warm-up, swap prepare, retrain episodes)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=self.capacity
        )
        self.epoch = time.perf_counter()
        self.dropped = 0            # spans pushed out of the ring

    # ---------------------------------------------------------- recording

    def record(self, name: str, t0: float, t1: float, *,
               cat: str = "serve", args: dict | None = None) -> None:
        """Record a completed span from raw ``perf_counter`` stamps."""
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(Span(
            name, cat, t0 - self.epoch, max(0.0, t1 - t0),
            threading.get_ident(), args or {},
        ))

    @contextmanager
    def span(self, name: str, *, cat: str = "serve", **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t0, time.perf_counter(), cat=cat,
                        args=args or None)

    # ------------------------------------------------------------ reading

    def spans(self) -> list[Span]:
        """Snapshot copy of the ring, oldest first."""
        return list(self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0

    def chrome_trace(self) -> dict:
        """The ring as Chrome ``trace_event`` JSON (object format).

        Complete events (``ph: "X"``), ``ts``/``dur`` in integer
        microseconds from the tracer epoch (monotonic, so events are
        well-ordered), ``pid`` fixed at 1 and ``tid`` a small stable
        int per recording thread.  Structure is what
        ``chrome://tracing`` / Perfetto load directly."""
        tids: dict[int, int] = {}
        events = []
        for s in self._spans:
            tid = tids.setdefault(s.tid, len(tids) + 1)
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": int(round(s.t0 * 1e6)),
                "dur": max(1, int(round(s.dur_s * 1e6))),
                "pid": 1,
                "tid": tid,
                "args": s.args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.telemetry",
                "dropped_spans": self.dropped,
            },
        }
