"""Plain PyTorch version of the MAT (quantized-LUT) classifier
(counterpart of ``repro.kernels.mat_lut.ref`` and of the arithmetic of the
Pallas ``mat_lut._kernel``).

Per feature f, in ascending order: the bucket is the count of edges
strictly below the value (``searchsorted`` side='left', done as a
compare-and-count so ties and NaN behave as in the Pallas kernel), and
the feature's table row for that bucket is added to the per-class
scores.  Then the arg-reduce (argmax, or argmin with ``use_min``; ties to
the lowest index) and the LabelMap gather.  The scores are summed one
feature at a time, as the Pallas kernel and CUDA kernel K4 sum them, so
the kernel matches this version bit for bit.
"""

from __future__ import annotations

import torch


def mat_buckets(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x [B, F], edges [F, E] -> buckets [B, F] int64: per feature the
    count of edges strictly below the value."""
    return (x.to(torch.float32)[:, :, None] > edges[None, :, :]).sum(2)


def mat_scores_ref(x: torch.Tensor, edges: torch.Tensor,
                   tables: torch.Tensor) -> torch.Tensor:
    """-> per-class scores [B, C] f32, features accumulated in ascending
    order starting from 0.0."""
    buckets = mat_buckets(x, edges)
    scores = torch.zeros((x.shape[0], tables.shape[2]), dtype=torch.float32,
                         device=x.device)
    for f in range(edges.shape[0]):
        scores = scores + tables[f][buckets[:, f]]
    return scores


def arg_reduce(scores: torch.Tensor, use_min: bool) -> torch.Tensor:
    """argmax (argmin with ``use_min``) over the last axis, ties to the
    lowest index (``torch.argmax``/``argmin`` return the first)."""
    fn = torch.argmin if use_min else torch.argmax
    return fn(scores, dim=1)


def mat_classify_ref(x: torch.Tensor, edges: torch.Tensor,
                     tables: torch.Tensor, lmap: torch.Tensor, *,
                     use_min: bool = False) -> torch.Tensor:
    """x [B, F] f32; edges [F, E] sorted rows; tables [F, E + 1, C];
    lmap [L] int (L >= C) -> verdicts [B] int32."""
    ids = arg_reduce(mat_scores_ref(x, edges, tables), use_min)
    return lmap.to(torch.int32)[ids]
