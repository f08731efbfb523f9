"""Unified telemetry plane for the serving path (counterpart of
``repro.telemetry``; numpy and the standard library only).

One ``Telemetry`` object bundles the three observability surfaces
(docs/pipeline_ir.md#telemetry-contract):

  * ``metrics``  — lock-free-on-the-hot-path counters/gauges/histograms
    with snapshot-on-read (``telemetry.metrics``);
  * ``tracer``   — monotonic-clock spans in a bounded ring, exportable
    as Chrome ``trace_event`` JSON (``telemetry.trace``);
  * ``journal``  — the append-only operator event log, JSON lines
    (``telemetry.journal``).

``serve.packet_engine.PacketServeEngine`` accepts ``telemetry=``
(default: a fresh enabled instance; ``False`` disables recording
entirely) and exposes the live object via ``engine.telemetry()``.
Everything is recorded on the host at dispatch-ring boundaries, from
host data only: the kernels, the overlap pipeline and every bit-identity
contract are untouched.  The overhead budget is the reference's: engine
pkt/s with telemetry on at least 97% of off (``chip_smoke.py``'s
``telemetry`` phase measures it on the card).
"""

from __future__ import annotations

from repro_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.telemetry.trace import Span, Tracer
from repro_torch.telemetry.journal import EVENT_KINDS, EventJournal
from repro_torch.telemetry.export import to_json, to_prometheus
from repro_torch.telemetry.flow_health import (
    batch_segmentation,
    mitigation_residency,
    table_health,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "EVENT_KINDS",
    "EventJournal",
    "Telemetry",
    "to_json",
    "to_prometheus",
    "table_health",
    "batch_segmentation",
    "mitigation_residency",
]


class Telemetry:
    """The bundle: one metrics registry + one tracer + one journal.

    Share ONE instance across the engines and controllers of a serving
    deployment so the exported view is a single coherent plane (the
    engines label their series by engine/backend); or give each engine
    its own — both compose.

    ``journal_path`` additionally appends every journal event to a
    JSON-lines file (the artifact CI uploads from the attack-defense
    replay)."""

    def __init__(self, *, journal_path: str | None = None,
                 trace_capacity: int = 4096,
                 journal_capacity: int = 65536):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(capacity=trace_capacity)
        self.journal = EventJournal(journal_path,
                                    capacity=journal_capacity)

    # ------------------------------------------------------------- export

    def snapshot(self) -> dict:
        """Point-in-time metrics copy (see MetricsRegistry.snapshot)."""
        return self.metrics.snapshot()

    def prometheus(self) -> str:
        """Current metrics in Prometheus text exposition format."""
        return to_prometheus(self.snapshot())

    def json(self) -> str:
        """Current metrics as a JSON document."""
        return to_json(self.snapshot())

    def chrome_trace(self) -> dict:
        """Recorded spans as Chrome ``trace_event`` JSON (object form)."""
        return self.tracer.chrome_trace()

    def close(self) -> None:
        self.journal.close()


def resolve(telemetry) -> "Telemetry | None":
    """Normalize an engine's ``telemetry=`` argument: ``None``/``True``
    -> a fresh enabled instance, ``False`` -> no telemetry (engines
    guard every recording site on ``is not None``), an existing
    ``Telemetry`` -> itself (shared plane)."""
    if telemetry is False:
        return None
    if telemetry is None or telemetry is True:
        return Telemetry()
    return telemetry
