"""Per-flow register file (counterpart of ``repro.flowstate.registers``).

A direct-indexed hash table with a fixed, power-of-two slot count.  Each
row holds ``n_counters`` accumulators, ``n_ewma`` exponential moving
averages and one histogram section per entry of ``hist_sizes``.  A packet
whose key differs from the stored key evicts the resident flow: the row
resets to zero and the new flow claims the slot (last writer wins).
Keys ``-1`` mark empty slots.

``migrate_state`` is the hot-swap re-key path for a changed spec.
``MultiFlowState`` is the state of a multi-table pipeline: several
register files feeding one classifier, plus an optional action table.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FlowStateSpec:
    """Shape of the per-flow register file.

    ``n_counters`` >= 1; counter 0 is the packet count (the lowering always
    increments it by 1 and ``WindowStats`` divides the histograms by it).
    Histogram sections sit back to back after the EWMA block."""

    n_slots: int = 1024
    n_counters: int = 1
    n_ewma: int = 0
    hist_sizes: tuple = ()
    ewma_alpha: float = 0.125

    def __post_init__(self):
        if self.n_slots < 2 or self.n_slots & (self.n_slots - 1):
            raise ValueError(
                f"n_slots must be a power of two >= 2, got {self.n_slots}"
            )
        if self.n_counters < 1:
            raise ValueError("n_counters must be >= 1 (slot 0 = pkt count)")
        if any(int(h) < 1 for h in self.hist_sizes):
            raise ValueError("every histogram needs >= 1 bin")
        # shift-EWMA contract: a power-of-two alpha keeps both blend
        # products exact in f32, so every engine (and any FMA contraction
        # a compiler picks) computes the same bits (see ref.ewma_blend)
        a = float(self.ewma_alpha)
        if self.n_ewma and not (0.0 < a < 1.0 and math.frexp(a)[0] == 0.5):
            raise ValueError(
                "ewma_alpha must be a power of two in (0, 1) "
                f"(shift-EWMA contract), got {self.ewma_alpha}"
            )

    @property
    def width(self) -> int:
        """Register words per flow row (counters + EWMAs + hist bins)."""
        return self.n_counters + self.n_ewma + sum(self.hist_sizes)

    @property
    def hist_offsets(self) -> tuple:
        """Absolute start column of each histogram section."""
        offs, base = [], self.n_counters + self.n_ewma
        for h in self.hist_sizes:
            offs.append(base)
            base += int(h)
        return tuple(offs)

    @property
    def sram_bytes(self) -> int:
        """Table footprint: rows plus the stored-key word per slot."""
        return self.n_slots * (self.width + 1) * 4


@dataclasses.dataclass
class FlowState:
    """The live register file.  A pipeline step on the card updates these
    tensors in place and returns them; on the CPU it returns fresh ones
    (see ``flowstate.pipeline``)."""

    spec: FlowStateSpec
    keys: torch.Tensor     # [S] int32 stored flow key, -1 = empty slot
    regs: torch.Tensor     # [S, W] f32 register rows

    @property
    def occupied(self) -> int:
        return int((self.keys >= 0).sum())


@dataclasses.dataclass
class MultiFlowState:
    """Live state of a multi-table stateful pipeline: one register file
    per ``FlowKey``/``RegisterUpdate`` group, and the action table when
    the pipeline ends in ``Mitigate`` (keyed by table 0's flow key).

    ``spec``/``keys``/``regs`` alias table 0, so readers of a single
    table (the telemetry health scan, engine stats, reprs) keep working;
    per-table access goes through the ``*_list`` tuples."""

    specs: tuple               # of FlowStateSpec, one per table
    keys_list: tuple           # of [S_t] int32 stored keys (-1 = empty)
    regs_list: tuple           # of [S_t, W_t] f32 register rows
    mit_spec: object = None    # mitigation.MitigationSpec | None
    mit_keys: torch.Tensor | None = None
    mit_regs: torch.Tensor | None = None

    @property
    def spec(self) -> FlowStateSpec:
        return self.specs[0]

    @property
    def keys(self) -> torch.Tensor:
        return self.keys_list[0]

    @property
    def regs(self) -> torch.Tensor:
        return self.regs_list[0]

    @property
    def occupied(self) -> int:
        """Occupied slots summed over every table."""
        return int(sum(int((k >= 0).sum()) for k in self.keys_list))

    @property
    def mitigated_flows(self) -> int:
        """Action slots currently marked (hits >= threshold)."""
        if self.mit_spec is None:
            return 0
        marked = (self.mit_keys >= 0) \
            & (self.mit_regs[:, 0] >= self.mit_spec.threshold)
        return int(marked.sum())


def init_state(spec: FlowStateSpec, device="cuda") -> FlowState:
    dev = resolve_device(device)
    return FlowState(
        spec,
        torch.full((spec.n_slots,), -1, dtype=torch.int32, device=dev),
        torch.zeros((spec.n_slots, spec.width), dtype=torch.float32,
                    device=dev),
    )


def hash_slot_np(keys: np.ndarray, n_slots: int) -> np.ndarray:
    """Numpy form of ``kernels.flow_update.ref.hash_slot`` (same Knuth
    multiplicative mix and xor-fold) for host-side use."""
    with np.errstate(over="ignore"):
        h = np.asarray(keys).astype(np.uint32) * np.uint32(2654435761)
    h = h ^ (h >> np.uint32(16))
    return (h & np.uint32(n_slots - 1)).astype(np.int32)


def migrate_state(state: FlowState, new_spec: FlowStateSpec) -> FlowState:
    """Re-key a register file for a hot swap that changes the spec (a
    same-spec swap keeps the live tensors).  Occupied rows re-hash into
    the new table walking slots in ascending order, so two old flows on
    one new slot resolve last-writer-wins, as live eviction would.
    Columns carry section by section: the shared prefix of counters, of
    EWMAs and of each histogram; what the new spec adds starts at zero,
    what it drops is discarded.  A host-side control-plane scan, not a
    per-packet path.  -> a ``FlowState`` on the input's device."""
    old = state.spec
    dev = state.keys.device
    keys = state.keys.cpu().numpy()
    regs = state.regs.cpu().numpy()
    out_k = np.full((new_spec.n_slots,), -1, np.int32)
    out_r = np.zeros((new_spec.n_slots, new_spec.width), np.float32)
    pairs = [(j, j) for j in range(min(old.n_counters, new_spec.n_counters))]
    pairs += [(old.n_counters + j, new_spec.n_counters + j)
              for j in range(min(old.n_ewma, new_spec.n_ewma))]
    for h, (o_off, n_off) in enumerate(zip(old.hist_offsets,
                                           new_spec.hist_offsets)):
        pairs += [(o_off + j, n_off + j) for j in
                  range(min(old.hist_sizes[h], new_spec.hist_sizes[h]))]
    o_cols = np.array([p[0] for p in pairs], np.int64)
    n_cols = np.array([p[1] for p in pairs], np.int64)
    occupied = np.flatnonzero(keys >= 0)       # ascending slot order
    for i, s in zip(occupied, hash_slot_np(keys[occupied],
                                           new_spec.n_slots)):
        out_k[s] = keys[i]
        out_r[s] = 0.0
        out_r[s, n_cols] = regs[i, o_cols]
    return FlowState(new_spec, torch.as_tensor(out_k, device=dev),
                     torch.as_tensor(out_r, device=dev))


def update_flows(state: FlowState, pkt_keys, upd, bins=None, valid=None, *,
                 backend: str = "interpret"):
    """One batched register update over a ``FlowState`` -> (new state,
    per-packet feature rows [B, W]) in arrival order.

    ``pkt_keys`` [B] int32 flow keys (>= 0); ``upd`` [B, C+E] counter
    increments ++ EWMA values; ``bins`` [B, H] absolute histogram columns
    (-1 = none; None: no histogram hit); ``valid`` [B] (0 = padding, never
    touches the table; None: every row).  ``backend="cuda"`` runs the
    ``flow_update`` op (K2 on CUDA tensors, which updates the state's
    tensors in place; its plain version on CPU tensors), ``"interpret"``
    the plain sequential version, which never writes its inputs.  Both
    are bit-identical."""
    from repro_torch.kernels import flow_update as fu

    if backend not in ("interpret", "cuda"):
        raise KeyError("backend must be 'interpret' or 'cuda'")
    spec, dev = state.spec, state.keys.device
    pkt_keys = torch.as_tensor(pkt_keys, dtype=torch.int32, device=dev)
    B = int(pkt_keys.shape[0])
    if bins is None:
        bins = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
    if valid is None:
        valid = torch.ones((B,), dtype=torch.int32, device=dev)
    fn = fu.flow_update if backend == "cuda" else fu.flow_update_ref
    keys, regs, feats = fn(
        state.keys, state.regs, pkt_keys,
        torch.as_tensor(upd, dtype=torch.float32, device=dev),
        torch.as_tensor(bins, dtype=torch.int32, device=dev),
        torch.as_tensor(valid, dtype=torch.int32, device=dev),
        n_counters=spec.n_counters, n_ewma=spec.n_ewma,
        alpha=spec.ewma_alpha)
    return FlowState(spec, keys, regs), feats
