"""Metrics registry: counters, gauges and histograms for the serving path.

Design constraints (docs/pipeline_ir.md#telemetry-contract):

  * **Lock-free on the hot path.**  Recording is a plain Python
    float/int mutation on a pre-resolved handle — one attribute add
    under the GIL, no lock, no allocation.  Handles are resolved ONCE
    (``registry.counter(name)`` at engine construction), so the
    per-batch cost is a couple of interpreter ops, never a dict lookup
    chain or a mutex.
  * **Snapshot-on-read.**  ``snapshot()`` copies every value at read
    time; readers (exporters, dashboards) never share mutable state
    with the recording thread, and a snapshot taken mid-serve is a
    consistent-enough point-in-time view (each individual value read is
    atomic under the GIL; cross-metric skew is bounded by one batch).
  * **Bounded memory.**  A metric's label children are interned in a
    dict keyed by the sorted label items; histograms have a FIXED
    bucket layout chosen at creation.  Nothing grows with traffic.

Vocabulary note: metric names are Prometheus-style snake case with the
unit as a suffix (``serve_packets_total``, ``serve_batch_latency_ms``);
the exporters in ``telemetry.export`` render them verbatim.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS",
]

# default histogram layout: sub-ms to multi-second latencies, log-ish
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared child-interning machinery; subclasses define the child."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: dict[tuple, object] = {}
        # child creation is rare (once per label set) and may race with
        # other creators — guard it; RECORDING on a child never locks
        self._create_lock = threading.Lock()

    def labels(self, **labels):
        """The child handle for one label set (interned; resolve once,
        record on the returned handle forever)."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._create_lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):
        raise NotImplementedError

    @property
    def default(self):
        """The label-less child (the common case)."""
        return self.labels()

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "help": self.help,
            "values": [
                {"labels": dict(key), **child._read()}
                for key, child in sorted(self._children.items())
            ],
        }


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n             # single GIL-atomic float add

    def _read(self) -> dict:
        return {"value": float(self.value)}


class Counter(_Metric):
    """Monotonically increasing count (packets, batches, evictions)."""

    kind = "counter"
    _new_child = staticmethod(_CounterChild)

    def inc(self, n: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(n)

    def value(self, **labels) -> float:
        return float(self.labels(**labels).value)


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def _read(self) -> dict:
        return {"value": float(self.value)}


class Gauge(_Metric):
    """Point-in-time level (table occupancy, in-flight depth)."""

    kind = "gauge"
    _new_child = staticmethod(_GaugeChild)

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)

    def value(self, **labels) -> float:
        return float(self.labels(**labels).value)


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # + overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def _read(self) -> dict:
        return {
            "buckets": [
                {"le": le, "count": c}
                for le, c in zip(
                    list(self.bounds) + [float("inf")], list(self.counts)
                )
            ],
            "sum": float(self.sum),
            "count": int(self.count),
        }


class Histogram(_Metric):
    """Fixed-bucket distribution (per-batch latency, dispatch time)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 buckets: tuple = DEFAULT_LATENCY_BUCKETS_MS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)


class MetricsRegistry:
    """Named metrics, get-or-create, snapshot-on-read.

    ``counter/gauge/histogram`` return the SAME metric object for
    repeated calls with one name (help/buckets are fixed by the first
    creation); asking for an existing name as a different kind is an
    error — one name, one type, like Prometheus."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._create_lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._create_lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *,
                  buckets: tuple = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Point-in-time copy of every metric: ``{name: {...}}``, JSON
        clean, safe to hold while recording continues."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}
