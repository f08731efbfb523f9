"""Plain PyTorch versions of the per-packet MLP (counterpart of
``repro.kernels.fused_mlp.ref``): x -> (dense + relu)* -> dense logits,
all in f32, and the classify form with the argmax over the logits."""

from __future__ import annotations

import torch


def mlp_ref(x, weights, biases) -> torch.Tensor:
    """x [B, F]; weights[i] [d_i, d_{i+1}]; biases[i] [d_{i+1}] -> logits."""
    h = x.to(torch.float32)
    L = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w.to(torch.float32) + b.to(torch.float32)
        if i < L - 1:
            h = torch.relu(h)
    return h


def mlp_tile_ref(x, weights, biases, rows: int, k_chunk: int
                 ) -> torch.Tensor:
    """The tiled schedule of K3/K5/K6 (``csrc/mlp_tile.cuh``) written out
    plainly -> logits [B, C] f32.  Rows go in tiles of ``rows`` (the last
    one padded with zero rows, as a block pads it); each layer's weights
    come in chunks of ``k_chunk`` input rows (the last one shorter); each
    output is one chain over ascending input index from 0, a step adding
    one product to the sum in f64 and rounding to f32 (the kernel's fmaf
    rounds once, so the two differ only where that double rounding does),
    then the f32 bias and ReLU on all but the last layer.  For the tests
    and the smoke's checks; no serving path runs it."""
    x = torch.as_tensor(x, dtype=torch.float32)
    B, F = x.shape
    n_tiles = -(-B // rows)
    h = torch.zeros((n_tiles * rows, F), dtype=torch.float32,
                    device=x.device)
    h[:B] = x
    h = h.view(n_tiles, rows, F)
    L = len(weights)
    for li, (w, b) in enumerate(zip(weights, biases)):
        w = torch.as_tensor(w, dtype=torch.float32).to(x.device,
                                                        torch.float64)
        d_in, d_out = w.shape
        acc = torch.zeros((n_tiles, rows, d_out), dtype=torch.float32,
                          device=x.device)
        for k0 in range(0, d_in, k_chunk):
            for k in range(k0, min(k0 + k_chunk, d_in)):
                acc = (acc.to(torch.float64)
                       + h[:, :, k, None].to(torch.float64) * w[k]
                       ).to(torch.float32)
        h = acc + torch.as_tensor(b, dtype=torch.float32).to(x.device)
        if li < L - 1:
            h = torch.relu(h)
    return h.reshape(n_tiles * rows, -1)[:B]


def mlp_classify_ref(x, weights, biases) -> torch.Tensor:
    """-> int32 class ids: argmax over the logits, ties to the lowest
    index (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(mlp_ref(x, weights, biases), dim=1).to(torch.int32)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """Gap between the two largest logits per row (inf for one class):
    verdicts may differ only where this is within the logit tolerance."""
    if logits.shape[1] < 2:
        return torch.full((logits.shape[0],), float("inf"),
                          device=logits.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]


# ------------------------------------------------------- cross-model DAG
#
# A DAG plan is the JAX package's nested structure (``kernel.py:124-156``):
#   ("model", i)                 leaf: verdict of model i
#   ("seq", (p0, p1, ...))       gate: flagged rows keep their verdict
#   ("or" | "and", (p0, ...))    parallel merge: max / min
# K6 takes it as a flat postfix program of (op, arg) pairs
# (``encode_plan``): DAG_MODEL i, then DAG_SEQ / DAG_OR / DAG_AND n for a
# node of n children.

DAG_MODEL, DAG_SEQ, DAG_OR, DAG_AND = 0, 1, 2, 3
_DAG_OPS = {"seq": DAG_SEQ, "or": DAG_OR, "and": DAG_AND}
_DAG_NAMES = {v: k for k, v in _DAG_OPS.items()}


def _fold(kind: str, parts: list) -> torch.Tensor:
    out = parts[0]
    for nxt in parts[1:]:
        if kind == "seq":
            out = torch.where(out > 0, out, nxt)
        elif kind == "or":
            out = torch.maximum(out, nxt)
        elif kind == "and":
            out = torch.minimum(out, nxt)
        else:
            raise KeyError(f"unknown DAG plan node {kind!r}")
    return out


def encode_plan(plan: tuple) -> tuple:
    """Nested plan -> postfix program ((op, arg), ...)."""
    if plan[0] == "model":
        return ((DAG_MODEL, int(plan[1])),)
    if plan[0] not in _DAG_OPS:
        raise KeyError(f"unknown DAG plan node {plan[0]!r}")
    out: tuple = ()
    for p in plan[1]:
        out += encode_plan(p)
    return out + ((_DAG_OPS[plan[0]], len(plan[1])),)


def decode_plan(program) -> tuple:
    """Postfix program -> the nested plan (``encode_plan``'s inverse);
    raises on a malformed program."""
    stack: list = []
    for op, arg in program:
        if op == DAG_MODEL:
            stack.append(("model", int(arg)))
            continue
        if op not in _DAG_NAMES or not 1 <= arg <= len(stack):
            raise ValueError(f"malformed DAG program at ({op}, {arg})")
        parts = tuple(stack[len(stack) - arg:])
        del stack[len(stack) - arg:]
        stack.append((_DAG_NAMES[op], parts))
    if len(stack) != 1:
        raise ValueError("a DAG program must leave one verdict")
    return stack[0]


def eval_dag_plan(plan: tuple, verdicts: list) -> torch.Tensor:
    """Fold per-model int32 verdicts through the nested DAG plan."""
    return eval_dag_program(encode_plan(plan), verdicts)


def eval_dag_program(program, verdicts: list) -> torch.Tensor:
    """Fold per-model verdicts through the postfix program, as K6's stack
    machine does."""
    stack: list = []
    for op, arg in program:
        if op == DAG_MODEL:
            stack.append(verdicts[arg])
            continue
        parts = stack[len(stack) - arg:]
        del stack[len(stack) - arg:]
        stack.append(_fold(_DAG_NAMES[op], parts))
    return stack[0]


def fused_dag_ref(x, models: list, program) -> torch.Tensor:
    """Plain version of K6 (counterpart of ``fused_dag_reference``,
    ``repro/kernels/fused_mlp/ops.py:147``): each model's MLP + argmax,
    folded on the verdicts by the plan's postfix program
    (``encode_plan``).  ``models`` is a list of (weights, biases) lists."""
    return eval_dag_program(program, [mlp_classify_ref(x, w, b)
                                      for w, b in models])
