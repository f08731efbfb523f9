"""Public op: the MAT (quantized-LUT) classifier in one launch
(counterpart of ``repro.kernels.mat_lut.ops.mat_classify``).

``mat_classify`` launches CUDA kernel K4 (``csrc/mat_lut.cu``) for CUDA
tensors and runs ``ref.mat_classify_ref`` for CPU tensors.

The tables are packed once (``pack_mat``, at lowering): edges [F, E]
f32, tables [F, E + 1, C] f32 and the label map as int32 padded with
zeros to at least C entries — an arg-reduce id with no LabelMap entry
maps to 0, as the Pallas kernel's zero-padded one-hot matvec maps it.
The storage of the edges and of the tables runs on past the views to a
multiple of 4 floats, so K4 stages each with whole 16-byte bulk copies;
K1 reads the same views with its own strides.  Envelope:
``MAX_FEATURES`` features and ``MAX_BINS`` bins (the reference's,
``mat_lut/ops.py:24-25``), ``MAX_CLASSES`` classes and label-map
entries, and edges + tables within ``MAX_TABLE_BYTES``, since a block
keeps them in shared memory.  ``pack_mat`` checks all of it, so K4's
wrapper checks only x and that the tables sit on x's device.  K4's
schedule follows from E: above ``SPLIT_EDGES`` (32) edges a feature's
count is split across the warp's lanes, on a copy of the edges padded
with +inf (``MatTables.k4_edges``), and at most 32 it takes one lane
(``ref.mat_classify_split_ref`` spells out the first).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.mat_lut.ref import SPLIT_EDGES, mat_classify_ref

MAX_FEATURES = _ext.header_define("RT_MAT_MAX_FEATURES")
MAX_BINS = _ext.header_define("RT_MAT_MAX_BINS")
MAX_CLASSES = 128
MAX_TABLE_BYTES = 192 * 1024


class MatTables(NamedTuple):
    """A MAT classifier packed for the kernels."""

    edges: torch.Tensor        # [F, E] f32, sorted rows
    tables: torch.Tensor       # [F, E + 1, C] f32
    lmap: torch.Tensor         # [L] int32, L >= C, zero padded
    use_min: bool
    # K4's edges: ``edges`` itself up to SPLIT_EDGES edges, else [F, E
    # rounded up to 32] with +inf past E (no value is above +inf, so the
    # split count needs no mask)
    k4_edges: torch.Tensor

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


def _bulk_padded(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` as contiguous f32 on ``dev`` whose storage runs on with zeros
    to a multiple of 4 floats (K4's bulk copies move 16-byte words)."""
    n = t.numel()
    buf = torch.zeros(((n + 3) // 4 * 4,), dtype=torch.float32, device=dev)
    buf[:n] = t.reshape(-1).to(dev)
    return buf[:n].view(t.shape)


def pack_mat(edges, tables, lmap=None, *, use_min: bool = False,
             device=None) -> MatTables:
    """Numpy or tensor MAT parameters -> ``MatTables`` on ``device``
    (default: the edges' device).  ``lmap`` None is the identity.
    Raises ``ValueError`` outside the kernels' envelope."""
    e = torch.as_tensor(np.asarray(edges, np.float32)) \
        if not torch.is_tensor(edges) else edges.to(torch.float32)
    t = torch.as_tensor(np.asarray(tables, np.float32)) \
        if not torch.is_tensor(tables) else tables.to(torch.float32)
    dev = device if device is not None else e.device
    if e.dim() != 2 or t.dim() != 3 or t.shape[0] != e.shape[0]:
        raise ValueError(f"MAT tables {tuple(t.shape)} do not fit "
                         f"edges {tuple(e.shape)}")
    C = int(t.shape[2])
    lm = (np.arange(C, dtype=np.int32) if lmap is None
          else np.asarray(lmap.cpu() if torch.is_tensor(lmap) else lmap,
                          np.int32))
    lm = np.concatenate([lm, np.zeros(max(0, C - len(lm)), np.int32)])
    reason = mat_envelope_reason(int(e.shape[0]), int(e.shape[1]),
                                 int(t.shape[1]), C, len(lm))
    if reason is not None:
        raise ValueError(f"outside the MAT-kernel envelope: {reason}")
    edges = _bulk_padded(e, dev)
    E = int(e.shape[1])
    k4 = edges
    if E > SPLIT_EDGES:
        k4 = torch.full((e.shape[0], -(-E // 32) * 32), float("inf"),
                        dtype=torch.float32, device=dev)
        k4[:, :E] = edges
    return MatTables(edges, _bulk_padded(t, dev),
                     torch.as_tensor(lm, device=dev), bool(use_min), k4)


def check_mat(mat: MatTables, device) -> None:
    """Every check ``pack_mat`` makes, on a ``MatTables`` from anywhere,
    and that its operands are contiguous and on ``device`` (K1's wrapper
    runs it on every call)."""
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
    one launch on the current stream.  ``mat`` comes from ``pack_mat``,
    which checked the tables once."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 2 or x.shape[1] != mat.n_features \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 [B, {mat.n_features}] "
                         f"on CUDA, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if mat.edges.device != x.device:
        raise ValueError(f"the MAT tables are on {mat.edges.device}, x on "
                         f"{x.device}")
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    _ext.extension().mat_lut_classify(x, mat.k4_edges, mat.tables,
                                      mat.lmap, out, bool(mat.use_min))
    _ext.count_launch("mat_lut_classify")
    return out


def mat_classify(x: torch.Tensor, mat: MatTables) -> torch.Tensor:
    """x [B, F] -> verdicts [B] int32: K4 for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return mat_classify_ref(x, mat.edges, mat.tables, mat.lmap,
                                use_min=mat.use_min)
    return mat_classify_launch(x.to(torch.float32).contiguous(), mat)
