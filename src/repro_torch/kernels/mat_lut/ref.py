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

from repro_torch.kernels import _ext


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


LANES = 32                    # a warp's lanes: K4 splits a count over them
# K4 splits the count over the lanes above this many edges
SPLIT_EDGES = _ext.header_define("RT_MAT_SPLIT_EDGES")
# features whose table loads K4 issues at once: 8 with one class a lane
# (C <= 32), 2 with up to four
SCORE_CHUNK = {1: 8, 4: 2}


def mat_classify_split_ref(x: torch.Tensor, edges: torch.Tensor,
                           tables: torch.Tensor, lmap: torch.Tensor, *,
                           use_min: bool = False) -> torch.Tensor:
    """K4's schedule written out in plain PyTorch; the same verdicts as
    ``mat_classify_ref``, bit for bit.  Bucket: above ``SPLIT_EDGES``
    edges, lane l of ``LANES`` counts edges l, l + 32, ... of the row
    padded with +inf to a multiple of 32 (``MatTables.k4_edges``) and the
    lanes' counts are summed (``__reduce_add_sync``); otherwise one lane
    counts them all.  Scores: per chunk of ``SCORE_CHUNK`` features, every
    feature's table offset and entry are fetched first, then the entries
    are added in ascending f to per-class sums that start at 0.0."""
    x = x.to(torch.float32)
    B, F = x.shape
    E = edges.shape[1]
    if E > SPLIT_EDGES:
        # the row padded with +inf to a multiple of 32: lane l compares
        # edges l, l + 32, ...; no value is above +inf
        pad = torch.full((F, (-E) % LANES), float("inf"),
                         device=edges.device)
        padded = torch.cat([edges.to(torch.float32), pad], 1)
        lanes = (x[:, :, None] > padded[None]).to(torch.int64).view(
            B, F, -1, LANES).sum(2)                        # [B, F, 32]
        buckets = lanes.sum(2)
    else:
        buckets = (x[:, :, None] > edges[None]).sum(2)
    C = tables.shape[2]
    offsets = (torch.arange(F, device=x.device)[None, :] * (E + 1)
               + buckets) * C                              # [B, F]
    flat = tables.reshape(-1)
    scores = torch.zeros((B, C), dtype=torch.float32, device=x.device)
    cls = torch.arange(C, device=x.device)
    chunk = SCORE_CHUNK[1 if C <= LANES else 4]
    for f0 in range(0, F, chunk):
        fs = range(f0, min(F, f0 + chunk))
        entries = [flat[offsets[:, f:f + 1] + cls[None, :]] for f in fs]
        for t in entries:
            scores = scores + t
    ids = arg_reduce(scores, use_min)
    return lmap.to(torch.int32)[ids]

