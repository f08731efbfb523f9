"""Operator event journal: append-only structured log (JSON lines).

Where metrics answer "how much" and spans answer "how long", the journal
answers *"what happened, when, in what order"* — the operator-relevant
state transitions of the serving plane:

=====================  =================================================
kind                   emitted when
=====================  =================================================
``drift``              the drift detector fires on served windows
``retrain_start``      a background retrain episode launches
``retrain_done``       the episode finishes (``ok`` False carries the
                       captured error — the engine kept the old model)
``hot_swap``           a parked swap installs at a ring boundary
                       (latency + packet offset of the boundary)
``mitigation_engage``  the action table marks new flows (count delta)
``mitigation_release`` marked flows leave the table (eviction/re-key)
``backend_fallback``   a requested engine lowered to a lesser one
                       (``"mixed"``, interpreter)
``slo_gate``           a benchmark/replay SLO gate evaluates
=====================  =================================================

Each event is one JSON object: ``seq`` (dense, per journal), ``t_s``
(monotonic seconds since the journal epoch — strictly ordered with
``seq``), ``wall`` (unix time, for cross-host correlation), ``kind``,
plus the event's own fields.  Events append to a bounded in-memory ring
AND, when a path is given, to a JSON-lines file (one event per line,
flushed per write) — the artifact CI uploads from the attack-defense
replay.

Emitting takes a small lock: journal events are RARE (swaps, drift,
gates — not per packet), so this is never on the per-batch hot path.
"""

from __future__ import annotations

import collections
import json
import threading
import time

__all__ = ["EVENT_KINDS", "EventJournal"]

# the documented operator event vocabulary
# (docs/pipeline_ir.md#telemetry-contract); emit() accepts other kinds
# too — the vocabulary is a contract floor, not a straitjacket
EVENT_KINDS = (
    "drift",
    "retrain_start",
    "retrain_done",
    "hot_swap",
    "mitigation_engage",
    "mitigation_release",
    "backend_fallback",
    "slo_gate",
)


class EventJournal:
    """Append-only, time-ordered operator event log."""

    def __init__(self, path: str | None = None, *, capacity: int = 65536):
        self.path = path
        self._events: collections.deque[dict] = collections.deque(
            maxlen=int(capacity)
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._epoch = time.perf_counter()
        self._file = None
        if path is not None:
            self._file = open(path, "a", encoding="utf-8")

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns the stamped record.  ``t_s`` is
        monotonic and, together with the dense ``seq``, totally orders
        the journal even when serving and retrain threads interleave."""
        with self._lock:
            event = {
                "seq": self._seq,
                "t_s": round(time.perf_counter() - self._epoch, 6),
                "wall": round(time.time(), 3),
                "kind": str(kind),
                **fields,
            }
            self._seq += 1
            self._events.append(event)
            if self._file is not None:
                self._file.write(json.dumps(event, default=str) + "\n")
                self._file.flush()
        return event

    # ------------------------------------------------------------ reading

    def events(self, kind: str | None = None) -> list[dict]:
        """Snapshot copy, oldest first; optionally one kind only."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def kinds(self) -> set[str]:
        return {e["kind"] for e in self.events()}

    def __len__(self) -> int:
        return len(self._events)

    def dump(self, path: str) -> str:
        """Write the in-memory ring as a JSON-lines file -> path."""
        with open(path, "w", encoding="utf-8") as f:
            for e in self.events():
                f.write(json.dumps(e, default=str) + "\n")
        return path

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    @staticmethod
    def load(path: str) -> list[dict]:
        """Parse a JSON-lines journal file back into event dicts."""
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
