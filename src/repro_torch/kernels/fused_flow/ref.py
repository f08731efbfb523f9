"""Plain PyTorch version of the fused stateful launch (counterpart of
the plain-jnp half of ``repro.kernels.fused_flow.kernel`` and of the
reference walk in ``fused_flow.ops``).

``TablePlan``/``SuffixPlan`` describe the launch statically, and the
folded action table's ``mitigate_ref.MitigationSpec`` its policy: one
table (``fused_flow_serve_ref``) or several feeding one classifier
(``fused_flow_serve_multi_ref``); the ``"mlp"``, ``"mat"`` and
``"centroid"`` suffixes; an optional folded action table.

Suffix parameters, packed once at lowering time:

  ``"mlp"``       ``fused_mlp.PackedMLP``
  ``"mat"``       ``mat_lut.MatTables`` (edges, tables, label map, use_min)
  ``"centroid"``  ``Centroids`` (centroids, FeatureSelect index, label
                  map, use_min)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flow_update.ref import flow_update_ref
from repro_torch.kernels.fused_flow.mitigate_ref import mitigate_update
from repro_torch.kernels.fused_mlp.ref import mlp_ref
from repro_torch.kernels.mat_lut.ref import (
    arg_reduce,
    mat_classify_ref,
    mat_scores_ref,
)

READOUT_MODES = ("all", "hist", "raw")
SUFFIX_KINDS = ("mlp", "mat", "centroid")


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

    kind: str                  # mlp | mat | centroid
    num_classes: int           # scores before any LabelMap rewrite


class Centroids(NamedTuple):
    """A centroid classifier packed for the kernels."""

    cent: torch.Tensor         # [K, D] f32
    fidx: torch.Tensor         # [D] int32 FeatureSelect index, or [0]
    lmap: torch.Tensor         # [L] int32, L >= K, zero padded
    use_min: bool

    @property
    def num_classes(self) -> int:
        return int(self.cent.shape[0])


def pack_centroids(cent, lmap=None, feature_idx=None, *,
                   use_min: bool = True, device=None) -> Centroids:
    """Numpy centroid parameters -> ``Centroids`` on ``device``.  An
    arg-reduce id with no LabelMap entry maps to 0, as the reference's
    zero-padded one-hot matvec maps it."""
    c = np.asarray(cent, np.float32)
    K = c.shape[0]
    lm = (np.arange(K, dtype=np.int32) if lmap is None
          else np.asarray(lmap, np.int32))
    lm = np.concatenate([lm, np.zeros(max(0, K - len(lm)), np.int32)])
    fi = np.asarray(() if feature_idx is None else feature_idx,
                    np.int32).ravel()
    return Centroids(torch.as_tensor(c, device=device),
                     torch.as_tensor(fi, device=device),
                     torch.as_tensor(lm, device=device), bool(use_min))


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


def centroid_scores_ref(z: torch.Tensor, c: Centroids) -> torch.Tensor:
    """Readout rows -> squared distances [B, K], features summed in
    ascending index (each square and sum rounded separately), after the
    folded FeatureSelect."""
    if c.fidx.numel():
        z = z[:, c.fidx.to(torch.int64)]
    z = z.to(torch.float32)
    acc = torch.zeros((z.shape[0], c.cent.shape[0]), dtype=torch.float32,
                      device=z.device)
    for i in range(c.cent.shape[1]):
        t = z[:, i:i + 1] - c.cent[None, :, i]
        acc = acc + t * t
    return acc


def suffix_scores(z: torch.Tensor, params, sp: SuffixPlan) -> torch.Tensor:
    """Readout rows -> the scores the arg-reduce reads: MLP logits, MAT
    per-class sums or centroid distances."""
    if sp.kind == "mlp":
        return suffix_logits(z, params)
    if sp.kind == "mat":
        return mat_scores_ref(z, params.edges, params.tables)
    if sp.kind == "centroid":
        return centroid_scores_ref(z, params)
    raise KeyError(f"suffix kind must be one of {SUFFIX_KINDS}")


def suffix_verdicts(z: torch.Tensor, params, sp: SuffixPlan) -> torch.Tensor:
    """Readout rows -> int32 verdicts: the arg-reduce (ties to the lowest
    index) and, for MAT and centroid, the LabelMap gather."""
    if sp.kind == "mlp":
        logits = suffix_logits(z, params)[:, :sp.num_classes]
        return torch.argmax(logits, dim=1).to(torch.int32)
    if sp.kind == "mat":
        return mat_classify_ref(z, params.edges, params.tables,
                                params.lmap, use_min=params.use_min)
    if sp.kind == "centroid":
        ids = arg_reduce(centroid_scores_ref(z, params), params.use_min)
        return params.lmap.to(torch.int32)[ids]
    raise KeyError(f"suffix kind must be one of {SUFFIX_KINDS}")


def fused_flow_serve_ref(keys, regs, pkt_keys, upd, bins, valid,
                         tp: TablePlan, sp: SuffixPlan, params, mit=None):
    """-> (keys' [S], regs' [S, W], verdicts [B] int32 in arrival order),
    or with ``mit = (mit_keys, mit_regs, MitigationSpec)`` -> (keys', regs',
    mit_keys', mit_regs', verdicts) with dropped packets ``MITIGATED``.

    Rows with ``valid == 0`` never touch a table; their verdict is the
    classifier's verdict on an all-zero readout row."""
    k2, r2, feats = flow_update_ref(
        keys, regs, pkt_keys, upd, bins, valid,
        n_counters=tp.n_counters, n_ewma=tp.n_ewma, alpha=tp.alpha)
    verd = suffix_verdicts(suffix_readout(feats, tp), params, sp)
    if mit is None:
        return k2, r2, verd
    mk, mr, spec = mit
    mk2, mr2, verd = mitigate_update(mk, mr, pkt_keys, verd, valid,
                                     spec=spec)
    return k2, r2, mk2, mr2, verd


def fused_flow_serve_multi_ref(tables, valid, tps, sp: SuffixPlan, params,
                               mit=None):
    """Several flow tables feeding one classifier.  ``tables`` is a
    sequence of (keys [S_t], regs [S_t, W_t], pkt_keys [B], upd, bins),
    one per ``TablePlan`` of ``tps``.  -> per table (keys', regs'), then
    (mit_keys', mit_regs') with ``mit = (mit_keys, mit_regs,
    MitigationSpec)``, then verdicts [B] int32 in arrival order.

    Each table updates by its own keys; the readout rows are concatenated
    in table order and classified once; the action table is keyed by
    table 0's keys.  Rows with ``valid == 0`` never touch a table."""
    outs, zs = [], []
    for (keys, regs, pkt_keys, upd, bins), tp in zip(tables, tps):
        k2, r2, feats = flow_update_ref(
            keys, regs, pkt_keys, upd, bins, valid,
            n_counters=tp.n_counters, n_ewma=tp.n_ewma, alpha=tp.alpha)
        outs += [k2, r2]
        zs.append(suffix_readout(feats, tp))
    verd = suffix_verdicts(torch.cat(zs, 1), params, sp)
    if mit is not None:
        mk, mr, spec = mit
        mk2, mr2, verd = mitigate_update(mk, mr, tables[0][2], verd, valid,
                                         spec=spec)
        outs += [mk2, mr2]
    return (*outs, verd)
