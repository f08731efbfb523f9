"""Public ops: the per-packet MLP (counterpart of
``repro.kernels.fused_mlp``).

  ``fused_mlp_classify``  MLP + argmax -> int32 ids: CUDA kernel K3
                          (``csrc/fused_mlp.cu``), plain
                          ``ref.mlp_classify_ref``;
  ``fused_mlp``           MLP -> f32 logits: K5 (same file), plain
                          ``ref.mlp_ref``;
  ``fused_dag``           a Seq/Par DAG of MLP classifiers -> int32
                          verdicts: K6 (``csrc/fused_dag.cu``), plain
                          ``ref.fused_dag_ref``.

Each launches its kernel for CUDA tensors and runs its plain version for
CPU tensors.

Packing: the weights are packed back to back at their true widths
(``pack_params``, ``pack_dag``), no lane padding, each packed array on a
16-byte boundary (the kernels bring the weights in with bulk copies).  A
model (a DAG's models) of at most ``MLP_CHUNK`` weights is staged whole
and runs one warp a row; a larger one streams through shared memory a
chunk at a time over tiles of rows (``tiled``, ``csrc/mlp_tile.cuh``).
So the envelope on the H100 is the widths and the depth only: layer
widths up to ``MAX_MLP_WIDTH`` and at most ``MAX_LAYERS`` layers (the JAX
package's is widths up to 128 at any depth).  A fused DAG takes at most
``MAX_DAG_MODELS`` distinct models and a plan of at most ``MAX_DAG_OPS``
instructions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _ext
from repro_torch.kernels.fused_mlp.ref import (
    encode_plan,
    fused_dag_ref,
    mlp_classify_ref,
    mlp_ref,
)

MAX_MLP_WIDTH = 256
MAX_LAYERS = 16
MAX_DAG_MODELS = 8
MAX_DAG_OPS = 32
MLP_CHUNK = _ext.header_define("RT_MLP_CHUNK")
TILE_ROWS = _ext.header_define("RT_MLP_TILE_ROWS")


def tiled(n_weights: int) -> bool:
    """Does a model (a DAG's models) of ``n_weights`` weights run the tile
    kernel, its weights past one chunk, rather than one warp a row?"""
    return n_weights > MLP_CHUNK


class PackedMLP(NamedTuple):
    """An MLP packed for the kernels: row-major [d_in, d_out] weights and
    the biases of every layer, concatenated in layer order."""

    w_flat: torch.Tensor     # [sum d_in*d_out] f32
    b_flat: torch.Tensor     # [sum d_out] f32
    widths: tuple            # (d_0, d_1, ..., d_L)

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    @property
    def num_classes(self) -> int:
        return self.widths[-1]

    def layers(self):
        """-> (weights, biases) lists of views (the plain versions' form)."""
        ws, bs, wo, bo = [], [], 0, 0
        for d_in, d_out in zip(self.widths[:-1], self.widths[1:]):
            ws.append(self.w_flat[wo:wo + d_in * d_out].view(d_in, d_out))
            bs.append(self.b_flat[bo:bo + d_out])
            wo += d_in * d_out
            bo += d_out
        return ws, bs


def mlp_envelope_reason(widths) -> str | None:
    """Why an MLP of these widths is outside the kernels' envelope."""
    widths = [int(w) for w in widths]
    if max(widths) > MAX_MLP_WIDTH:
        return f"classifier width {max(widths)} > {MAX_MLP_WIDTH}"
    if len(widths) - 1 > MAX_LAYERS:
        return f"classifier has {len(widths) - 1} layers > {MAX_LAYERS}"
    return None


def pack_params(weights, biases, device=None) -> PackedMLP:
    """weights[i] [d_i, d_{i+1}], biases[i] [d_{i+1}] (tensors or numpy)
    -> ``PackedMLP`` on ``device`` (default: the first weight's)."""
    ws = [torch.as_tensor(w, dtype=torch.float32) for w in weights]
    bs = [torch.as_tensor(b, dtype=torch.float32) for b in biases]
    dev = device if device is not None else ws[0].device
    widths = (int(ws[0].shape[0]),) + tuple(int(w.shape[1]) for w in ws)
    for w, b, d_in, d_out in zip(ws, bs, widths[:-1], widths[1:]):
        if tuple(w.shape) != (d_in, d_out) or tuple(b.shape) != (d_out,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)} do not chain at {d_in}")
    w_flat = torch.cat([w.reshape(-1) for w in ws]).to(dev).contiguous()
    b_flat = torch.cat(bs).to(dev).contiguous()
    return PackedMLP(w_flat, b_flat, widths)


def check_mlp(mlp: PackedMLP, device) -> None:
    reason = mlp_envelope_reason(mlp.widths)
    if reason is not None:
        raise ValueError(f"outside the MLP-kernel envelope: {reason}")
    check_packed(mlp.w_flat, mlp.b_flat, device, "MLP")


def check_packed(w_flat, b_flat, device, what: str) -> None:
    """Packed weights and biases: contiguous f32 on ``device``."""
    for t in (w_flat, b_flat):
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"packed {what} must be contiguous f32 on "
                             f"{device}, got {t.dtype} on {t.device}")


def check_aligned(w_flat, b_flat, what: str) -> None:
    """K3, K5 and K6 bring the weights in with bulk copies: each packed
    array starts on a 16-byte boundary."""
    if w_flat.data_ptr() % 16 or b_flat.data_ptr() % 16:
        raise ValueError(f"packed {what} must start on a 16-byte boundary")


def check_rows(x: torch.Tensor, width: int) -> None:
    """A kernel's input rows: contiguous f32 [B, width] on CUDA."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 2 or x.shape[1] != width \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 [B, {width}] on CUDA, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def fused_mlp_classify_launch(x: torch.Tensor, mlp: PackedMLP):
    """K3's wrapper: x [B, d_0] f32 contiguous CUDA -> [B] int32 ids, one
    launch on the current stream."""
    check_mlp(mlp, x.device)
    check_aligned(mlp.w_flat, mlp.b_flat, "MLP")
    check_rows(x, mlp.widths[0])
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    _ext.extension().fused_mlp_classify(x, mlp.w_flat, mlp.b_flat,
                                        list(mlp.widths), out)
    _ext.count_launch("fused_mlp_classify")
    return out


def fused_mlp_classify_packed(x: torch.Tensor, mlp: PackedMLP):
    """x [B, F] -> class ids [B] int32 for a pre-packed model."""
    if x.device.type == "cpu":
        ws, bs = mlp.layers()
        return mlp_classify_ref(x, ws, bs)
    return fused_mlp_classify_launch(x.to(torch.float32).contiguous(), mlp)


def fused_mlp_classify(x: torch.Tensor, weights, biases):
    """x [B, F] -> class ids [B] int32, argmax fused into the kernel."""
    return fused_mlp_classify_packed(
        x, pack_params(weights, biases, device=x.device))


# --------------------------------------------------------------- K5


def fused_mlp_launch(x: torch.Tensor, mlp: PackedMLP):
    """K5's wrapper: x [B, d_0] f32 contiguous CUDA -> logits [B, C] f32,
    one launch on the current stream."""
    check_mlp(mlp, x.device)
    check_aligned(mlp.w_flat, mlp.b_flat, "MLP")
    check_rows(x, mlp.widths[0])
    out = torch.empty((x.shape[0], mlp.num_classes), dtype=torch.float32,
                      device=x.device)
    _ext.extension().fused_mlp(x, mlp.w_flat, mlp.b_flat, list(mlp.widths),
                               out)
    _ext.count_launch("fused_mlp")
    return out


def fused_mlp_packed(x: torch.Tensor, mlp: PackedMLP):
    """x [B, F] -> logits [B, C] f32 for a pre-packed model."""
    if x.device.type == "cpu":
        ws, bs = mlp.layers()
        return mlp_ref(x, ws, bs)
    return fused_mlp_launch(x.to(torch.float32).contiguous(), mlp)


def fused_mlp(x: torch.Tensor, weights, biases):
    """x [B, F] -> logits [B, C] f32 (counterpart of
    ``repro.kernels.fused_mlp.fused_mlp``)."""
    return fused_mlp_packed(x, pack_params(weights, biases, device=x.device))


# --------------------------------------------------------------- K6


class PackedDag(NamedTuple):
    """A DAG of MLP classifiers packed for K6: every model's weights and
    biases back to back in model order, each model's widths (all starting
    at the DAG's input width) and the plan's postfix program."""

    w_flat: torch.Tensor     # f32
    b_flat: torch.Tensor     # f32
    widths: tuple            # per model: (d_0, ..., d_L)
    program: tuple           # ((op, arg), ...), ``ref.encode_plan``

    @property
    def n_models(self) -> int:
        return len(self.widths)

    @property
    def n_feat(self) -> int:
        return self.widths[0][0]

    def models(self):
        """-> [(weights, biases)] per model, as views."""
        out, wo, bo = [], 0, 0
        for widths in self.widths:
            nw = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
            nb = sum(widths[1:])
            mlp = PackedMLP(self.w_flat[wo:wo + nw], self.b_flat[bo:bo + nb],
                            widths)
            out.append(mlp.layers())
            wo += nw
            bo += nb
        return out


def dag_envelope_reason(widths, plan: tuple) -> str | None:
    """Why a DAG of models of these widths under ``plan`` is outside K6's
    envelope, or None."""
    if not widths:
        return "a DAG needs at least one model"
    if len(widths) > MAX_DAG_MODELS:
        return f"DAG has {len(widths)} distinct models > {MAX_DAG_MODELS}"
    n_feat = int(widths[0][0])
    for w in widths:
        if int(w[0]) != n_feat:
            return "DAG models disagree on the input width"
        reason = mlp_envelope_reason(w)
        if reason is not None:
            return reason
    try:
        program = encode_plan(plan)
    except KeyError as e:
        return str(e)
    if len(program) > MAX_DAG_OPS:
        return f"DAG plan has {len(program)} instructions > {MAX_DAG_OPS}"
    if any(op == 0 and not 0 <= arg < len(widths) for op, arg in program):
        return "DAG plan names a model it was not given"
    return None


def pack_dag(models, plan: tuple, device=None) -> PackedDag:
    """models: [(weights, biases)] (tensors or numpy, every first layer of
    the DAG's input width) and the nested plan -> ``PackedDag`` on
    ``device``; raises outside the envelope."""
    packed = [pack_params(w, b, device=device) for w, b in models]
    widths = tuple(p.widths for p in packed)
    reason = dag_envelope_reason(widths, plan)
    if reason is not None:
        raise ValueError(f"outside the fused-DAG envelope: {reason}")
    return PackedDag(torch.cat([p.w_flat for p in packed]).contiguous(),
                     torch.cat([p.b_flat for p in packed]).contiguous(),
                     widths, encode_plan(plan))


def fused_dag_launch(x: torch.Tensor, dag: PackedDag):
    """K6's wrapper: x [B, F] f32 contiguous CUDA -> verdicts [B] int32,
    one launch on the current stream."""
    check_packed(dag.w_flat, dag.b_flat, x.device, "DAG")
    check_aligned(dag.w_flat, dag.b_flat, "DAG")
    check_rows(x, dag.n_feat)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    _ext.extension().fused_dag(
        x, dag.w_flat, dag.b_flat, [len(w) - 1 for w in dag.widths],
        [int(d) for w in dag.widths for d in w],
        [int(v) for pair in dag.program for v in pair], out)
    _ext.count_launch("fused_dag")
    return out


def fused_dag(x: torch.Tensor, dag: PackedDag):
    """x [B, F] -> DAG verdicts [B] int32 (counterpart of
    ``repro.kernels.fused_mlp.fused_dag``)."""
    if x.device.type == "cpu":
        return fused_dag_ref(x, dag.models(), dag.program)
    return fused_dag_launch(x.to(torch.float32).contiguous(), dag)
