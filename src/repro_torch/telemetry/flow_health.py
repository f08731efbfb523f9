"""Flow-table health: occupancy, churn and schedule statistics.

Two kinds of measurement, both deliberately OFF the device hot path
(docs/pipeline_ir.md#telemetry-contract):

  * ``table_health`` — a cheap host-side scan of the live register
    file(s) at flush/swap boundaries (one ``[S]`` int compare per
    table): occupancy, insert/eviction counts since the previous scan,
    and — for mitigated pipelines — action-table residency and marked
    flows.  The scan forces a device→host copy of the key vector only;
    register rows are never touched.
  * ``batch_segmentation`` — per-batch slot-collision statistics
    recomputed host-side from the packet rows the engine staged
    (``FlowKey.apply_keys_np``): the same stable-sort rank the kernels'
    slot segmentation uses.  ``drain_heavy`` flags batches where more
    than 7/8 of live packets sit deeper than ``PAR_ROUNDS`` in one
    chain, exactly as the reference defines it: a traffic-shape signal
    of deep same-slot chains, which the port's kernels walk serially in
    one warp (nothing is routed away).
"""

from __future__ import annotations

import numpy as np

__all__ = ["table_health", "batch_segmentation", "mitigation_residency"]


def _host(a) -> np.ndarray:
    """A host array of ``a``: a device tensor (anything with ``.cpu()``)
    is copied to the host first."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


# the reference's lockstep-round count
# (repro/kernels/flow_update/kernel.py:67), kept so that ``n_deep`` and
# ``drain_heavy`` mean what they mean there
PAR_ROUNDS = 8


def mitigation_residency(state) -> dict:
    """Action-table residency of a (possibly sharded) mitigated state:
    occupied slots and flows past the mark threshold.  Zeroes for a
    state without an action table."""
    mit_spec = getattr(state, "mit_spec", None)
    if mit_spec is None:
        return {"mit_slots": 0, "mit_occupied": 0, "mit_marked": 0}
    mk = _host(state.mit_keys)
    hits = _host(state.mit_regs[..., 0])
    return {
        "mit_slots": int(mk.size),
        "mit_occupied": int(np.sum(mk >= 0)),
        "mit_marked": int(np.sum((mk >= 0) & (hits >= mit_spec.threshold))),
    }


def table_health(state, prev_keys: np.ndarray | None = None) -> dict:
    """Health scan of a live flow state (plain, mitigated or sharded).

    ``prev_keys`` is the key vector (or stacked ``[D, S]`` matrix) from
    the previous scan; when given, ``inserts`` counts slots that went
    empty→occupied and ``evictions`` slots whose stored key CHANGED
    while occupied (the last-writer-wins collision policy displacing a
    live flow) since then.  Returns the current keys under
    ``"keys"`` for the caller to carry to the next scan."""
    keys = _host(state.keys)
    occupied = int(np.sum(keys >= 0))
    total = int(keys.size)
    out = {
        "slots": total,
        "occupied": occupied,
        "occupancy_frac": occupied / max(total, 1),
        "inserts": 0,
        "evictions": 0,
        "keys": keys,
    }
    if prev_keys is not None and prev_keys.shape == keys.shape:
        prev = np.asarray(prev_keys)
        out["inserts"] = int(np.sum((prev < 0) & (keys >= 0)))
        out["evictions"] = int(
            np.sum((prev >= 0) & (keys >= 0) & (prev != keys))
        )
    out.update(mitigation_residency(state))
    return out


def batch_segmentation(slots: np.ndarray, *,
                       par_rounds: int | None = None) -> dict:
    """Slot-collision statistics of one dispatched batch.

    ``slots`` is the per-packet table slot (``hash_slot`` of the flow
    key) of every REAL row in the batch (padding excluded — the engine
    dispatches real rows and pads separately).  Mirrors the fused
    kernel's segmentation prelude: per-slot arrival rank, packets
    deeper than ``par_rounds`` (the drain set), and the drain-heavy
    flag ``n_deep * 8 > n_live * 7`` — the drain-dominated traffic
    shape (the reference's kernel serves it by its compacted drain; the
    port's K1 walks every chain, so here it describes traffic only).

    A slot's packets take ranks 0 .. count - 1, so the statistics follow
    from the per-slot counts alone: ``n_deep`` is the sum of
    ``max(0, count - par_rounds)`` and ``max_chain`` the largest count —
    the reference's values without its sort."""
    if par_rounds is None:
        par_rounds = PAR_ROUNDS
    slots = np.asarray(slots)
    n_live = int(slots.size)
    if n_live == 0:
        return {"n_live": 0, "n_deep": 0, "max_chain": 0,
                "drain_heavy": False}
    counts = np.bincount(slots)          # slots are table indices, >= 0
    n_deep = int(np.maximum(counts - par_rounds, 0).sum())
    return {
        "n_live": n_live,
        "n_deep": n_deep,
        "max_chain": int(counts.max()),
        "drain_heavy": bool(n_deep * 8 > n_live * 7),
    }
