"""Plain PyTorch version of the fused stateful launch (counterpart of the
plain-jnp half of ``repro.kernels.fused_flow.kernel`` and of the
reference walk in ``fused_flow.ops``).

``TablePlan``/``SuffixPlan`` describe the launch statically.  This slice
ports one table, the ``"mlp"`` suffix and no mitigation; the MAT and
centroid suffixes, the action table and multi-table plans wait for later
slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flow_update.ref import flow_update_ref
from repro_torch.kernels.fused_mlp.ref import mlp_ref

READOUT_MODES = ("all", "hist", "raw")
SUFFIX_KINDS = ("mlp",)


class TablePlan(NamedTuple):
    """Static description of one flow table's update + readout."""

    n_counters: int
    n_ewma: int
    n_hists: int
    alpha: float
    width: int                 # register width W
    mode: str                  # readout: all | hist | raw

    @property
    def head(self) -> int:
        return self.n_counters + self.n_ewma

    @property
    def n_out(self) -> int:
        """Readout width the classifier consumes."""
        return self.width - self.head if self.mode == "hist" else self.width


class SuffixPlan(NamedTuple):
    """Static description of the in-kernel classifier."""

    kind: str                  # "mlp" (the only kind ported so far)
    num_classes: int


def suffix_readout(feats: torch.Tensor, tp: TablePlan) -> torch.Tensor:
    """Post-update feature rows -> classifier input (WindowStats folded:
    histograms divided by ``max(count, 1)``; ``"raw"`` = no WindowStats)."""
    if tp.mode not in READOUT_MODES:
        raise KeyError(f"readout mode must be one of {READOUT_MODES}")
    if tp.mode == "raw":
        return feats[:, :tp.width]
    denom = torch.clamp(feats[:, :1], min=1.0)   # counter 0 = pkt count
    hist = feats[:, tp.head:tp.width] / denom
    if tp.mode == "hist":
        return hist
    return torch.cat([feats[:, :tp.head], hist], 1)


def suffix_logits(z: torch.Tensor, mlp) -> torch.Tensor:
    """Readout rows -> MLP logits (``mlp`` is a ``fused_mlp.PackedMLP``)."""
    ws, bs = mlp.layers()
    return mlp_ref(z, ws, bs)


def suffix_verdicts(z: torch.Tensor, mlp, sp: SuffixPlan) -> torch.Tensor:
    """Readout rows -> int32 class ids (argmax, ties to the lowest)."""
    if sp.kind not in SUFFIX_KINDS:
        raise NotImplementedError(f"{sp.kind} suffix not yet ported")
    logits = suffix_logits(z, mlp)[:, :sp.num_classes]
    return torch.argmax(logits, dim=1).to(torch.int32)


def fused_flow_serve_ref(keys, regs, pkt_keys, upd, bins, valid,
                         tp: TablePlan, sp: SuffixPlan, mlp):
    """-> (keys' [S], regs' [S, W], verdicts [B] int32 in arrival order).

    Rows with ``valid == 0`` never touch the table; their verdict is the
    classifier's verdict on an all-zero readout row."""
    k2, r2, feats = flow_update_ref(
        keys, regs, pkt_keys, upd, bins, valid,
        n_counters=tp.n_counters, n_ewma=tp.n_ewma, alpha=tp.alpha)
    return k2, r2, suffix_verdicts(suffix_readout(feats, tp), mlp, sp)
