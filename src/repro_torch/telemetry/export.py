"""Exporters: Prometheus text format and JSON over a metrics snapshot.

Both operate on ``MetricsRegistry.snapshot()`` output — a frozen copy —
so exporting never races the recording threads and costs the hot path
nothing.  The Prometheus rendering follows the text exposition format
(``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples,
histogram ``_bucket``/``_sum``/``_count`` expansion with cumulative
``le`` buckets).
"""

from __future__ import annotations

import json

__all__ = ["to_prometheus", "to_json"]


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()`` as Prometheus text."""
    lines: list[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        for val in m["values"]:
            labels = val.get("labels", {})
            if m["kind"] == "histogram":
                cum = 0
                for b in val["buckets"]:
                    cum += b["count"]
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_value(b['le'])})}"
                        f" {cum}"
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)}"
                    f" {_fmt_value(val['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {val['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)}"
                    f" {_fmt_value(val['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(snapshot: dict, *, indent: int | None = None) -> str:
    """The snapshot as a JSON document (it is already JSON-clean)."""
    return json.dumps(snapshot, indent=indent, sort_keys=True)
