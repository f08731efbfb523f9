"""Per-flow register file (counterpart of ``repro.flowstate.registers``).

A direct-indexed hash table with a fixed, power-of-two slot count.  Each
row holds ``n_counters`` accumulators, ``n_ewma`` exponential moving
averages and one histogram section per entry of ``hist_sizes``.  A packet
whose key differs from the stored key evicts the resident flow: the row
resets to zero and the new flow claims the slot (last writer wins).
Keys ``-1`` mark empty slots.

``migrate_state`` (the hot-swap re-key path) is not ported yet.
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
