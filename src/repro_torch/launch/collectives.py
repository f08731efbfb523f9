"""Collective inventory and wire-byte accounting of a traced step
(counterpart of ``repro.launch.hlo``).

The reference parses the partitioned HLO, where every shape on a
collective line is a per-device shard.  The port reads the functional
collectives that DTensor issues while a step is traced
(``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``), whose operands are rank 0's local
tensors, with the size of the group each runs over.  For each it
records the result bytes, the group size and the *wire bytes per
device* under the standard ring-algorithm model, the reference's
formulas unchanged:

  all-gather      result R over group g: send/recv R*(g-1)/g
  all-reduce      operand O (= result):  2*O*(g-1)/g   (RS + AG phases)
  reduce-scatter  result R (operand R*g): R*(g-1)      == O*(g-1)/g
  all-to-all      operand O: O*(g-1)/g
  collective-permute  operand O: O

``wire_bytes_bf16`` equals ``wire_bytes``: the reference re-costs f32
collectives at 2 bytes because XLA's CPU backend widens bf16 matmul
operands before a collective, and the port's trace keeps each tensor's
own dtype, so there is nothing to correct.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collective op name -> the reference's HLO kind
FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class Collective:
    kind: str
    dtype: str
    result_bytes: int
    group_size: int
    wire_bytes: float       # per-device wire traffic
    wire_bytes_bf16: float  # the same: the trace keeps each tensor's dtype
    line: str


def ring_wire_bytes(kind: str, result_bytes: float, group_size: int
                    ) -> float:
    """Per-device wire bytes of one collective under the ring model."""
    g = group_size
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "all-reduce":
        return 2 * result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * frac
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"collective kind {kind!r}: one of {KINDS}")


def collective(kind: str, dtype: str, result_bytes: int, group_size: int,
               line: str = "") -> Collective:
    wire = ring_wire_bytes(kind, result_bytes, group_size)
    return Collective(kind, dtype, int(result_bytes), int(group_size), wire,
                      wire, line[:200])


def summarize_collectives(colls: list[Collective]) -> dict:
    by_kind: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "wire_bytes": 0.0, "wire_bytes_bf16": 0.0})
    for c in colls:
        d = by_kind[c.kind]
        d["count"] += 1
        d["wire_bytes"] += c.wire_bytes
        d["wire_bytes_bf16"] += c.wire_bytes_bf16
    total = {
        "wire_bytes": sum(c.wire_bytes for c in colls),
        "wire_bytes_bf16": sum(c.wire_bytes_bf16 for c in colls),
        "count": len(colls),
    }
    return {"by_kind": dict(by_kind), "total": total}


def op_histogram(counts: dict[str, int], top: int = 12) -> dict[str, int]:
    """The ``top`` most frequent ops of a trace (the reference's
    ``hlo_op_histogram``, over aten ops)."""
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])
