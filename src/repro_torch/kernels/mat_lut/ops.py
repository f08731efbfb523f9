"""Public op: the MAT (quantized-LUT) classifier in one launch
(counterpart of ``repro.kernels.mat_lut.ops.mat_classify``).

``mat_classify`` launches CUDA kernel K4 (``csrc/mat_lut.cu``) for CUDA
tensors and runs ``ref.mat_classify_ref`` for CPU tensors.

The tables are packed once (``pack_mat``): edges [F, E] f32, tables
[F, E + 1, C] f32 and the label map as int32 padded with zeros to at
least C entries — an arg-reduce id with no LabelMap entry maps to 0, as
the Pallas kernel's zero-padded one-hot matvec maps it.  Envelope:
``MAX_FEATURES`` features and ``MAX_BINS`` bins (the reference's,
``mat_lut/ops.py:24-25``), ``MAX_CLASSES`` classes and label-map
entries, and edges + tables within ``MAX_TABLE_BYTES``, since a block
keeps them in shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.mat_lut.ref import mat_classify_ref

MAX_FEATURES = 64
MAX_BINS = 1024
MAX_CLASSES = 128
MAX_TABLE_BYTES = 192 * 1024


class MatTables(NamedTuple):
    """A MAT classifier packed for the kernels."""

    edges: torch.Tensor        # [F, E] f32, sorted rows
    tables: torch.Tensor       # [F, E + 1, C] f32
    lmap: torch.Tensor         # [L] int32, L >= C, zero padded
    use_min: bool

    @property
    def n_features(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.tables.shape[2])


def mat_envelope_reason(n_features: int, n_edges: int, n_bins: int,
                        n_classes: int, n_labels: int) -> str | None:
    """Why a MAT of these shapes is outside the kernels' envelope."""
    if n_bins != n_edges + 1:
        return (f"MAT edges ({n_edges} per feature) and tables ({n_bins} "
                "bins) disagree on the bin count")
    if n_features > MAX_FEATURES:
        return f"MAT has {n_features} features > {MAX_FEATURES}"
    if n_bins > MAX_BINS:
        return f"MAT has {n_bins} bins > {MAX_BINS}"
    if n_classes > MAX_CLASSES or n_labels > MAX_CLASSES:
        return (f"MAT has {n_classes} classes / {n_labels} labels > "
                f"{MAX_CLASSES}")
    nbytes = 4 * n_features * (n_edges + n_bins * n_classes)
    if nbytes > MAX_TABLE_BYTES:
        return (f"MAT tables {nbytes} B exceed {MAX_TABLE_BYTES} B of "
                "shared memory")
    return None


def pack_mat(edges, tables, lmap=None, *, use_min: bool = False,
             device=None) -> MatTables:
    """Numpy or tensor MAT parameters -> ``MatTables`` on ``device``
    (default: the edges' device).  ``lmap`` None is the identity."""
    e = torch.as_tensor(np.asarray(edges, np.float32)) \
        if not torch.is_tensor(edges) else edges.to(torch.float32)
    t = torch.as_tensor(np.asarray(tables, np.float32)) \
        if not torch.is_tensor(tables) else tables.to(torch.float32)
    dev = device if device is not None else e.device
    C = int(t.shape[2])
    lm = (np.arange(C, dtype=np.int32) if lmap is None
          else np.asarray(lmap.cpu() if torch.is_tensor(lmap) else lmap,
                          np.int32))
    lm = np.concatenate([lm, np.zeros(max(0, C - len(lm)), np.int32)])
    return MatTables(e.to(dev).contiguous(), t.to(dev).contiguous(),
                     torch.as_tensor(lm, device=dev), bool(use_min))


def check_mat(mat: MatTables, device) -> None:
    F, E = mat.edges.shape
    if mat.tables.dim() != 3 or mat.tables.shape[0] != F:
        raise ValueError(f"MAT tables {tuple(mat.tables.shape)} do not fit "
                         f"edges {tuple(mat.edges.shape)}")
    reason = mat_envelope_reason(F, E, int(mat.tables.shape[1]),
                                 mat.num_classes, int(mat.lmap.shape[0]))
    if reason is not None:
        raise ValueError(f"outside the MAT-kernel envelope: {reason}")
    if mat.lmap.shape[0] < mat.num_classes:
        raise ValueError("the label map must cover every class")
    for t, dt in ((mat.edges, torch.float32), (mat.tables, torch.float32),
                  (mat.lmap, torch.int32)):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"MAT operand must be contiguous {dt} on "
                             f"{device}, got {t.dtype} on {t.device}")


def mat_classify_launch(x: torch.Tensor, mat: MatTables) -> torch.Tensor:
    """K4's wrapper: x [B, F] f32 contiguous CUDA -> verdicts [B] int32,
    one launch on the current stream."""
    check_mat(mat, x.device)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 2 or x.shape[1] != mat.n_features \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 [B, {mat.n_features}] "
                         f"on CUDA, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    _ext.extension().mat_lut_classify(x, mat.edges, mat.tables, mat.lmap,
                                      out, bool(mat.use_min))
    _ext.count_launch("mat_lut_classify")
    return out


def mat_classify(x: torch.Tensor, mat: MatTables) -> torch.Tensor:
    """x [B, F] -> verdicts [B] int32: K4 for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return mat_classify_ref(x, mat.edges, mat.tables, mat.lmap,
                                use_min=mat.use_min)
    return mat_classify_launch(x.to(torch.float32).contiguous(), mat)
