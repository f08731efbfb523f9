"""Per-device cost of one step traced on ``meta`` tensors (counterpart
of ``repro.launch.hlo_cost``).

The reference parses its partitioned HLO, infers the scans' trip counts
and sums over the per-device program.  The port runs its step eagerly on
``meta`` ``DTensor``s over a fake process group (nothing is allocated or
computed) under ``StepCost``, a dispatch mode that sees rank 0's local
program: DTensor hands each op the local shards after its own
redistribution, and the mode counts those ops.  It skips the ops that
DTensor's sharding propagation runs on global shapes to learn an
output's shape, which no rank runs.  The layer and microbatch loops are
Python loops, so the count is loop-exact by construction and
``unknown_loops`` is 0.

  * flops      2 * M * N * K for every product (``mm``, ``addmm``,
               ``bmm``, ``baddbmm``), per device, plus each hand-written
               kernel's operations as the bound column of the port's
               kernel table counts them (K7, K7b, K8, K8b report them on
               meta tensors through ``kernels._ext.record_cost``)
  * hbm_bytes  each op's operands plus its result, as the reference
               charges an unfused top-level op: views, allocations and
               collectives' waits are free, a gather or index reads only
               what it produces (2 x result), a scatter or index_put
               reads and writes the slots it updates (3 x update); the
               kernels' bytes are their formulas'
  * collectives  the functional collectives DTensor issues, rank 0's
               operands and the group each runs over, under the ring wire
               model of ``launch.collectives``
  * peak_bytes the largest sum of live local storages over the step,
               the inputs' local shards included (``track``)
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.collectives import FUNCTIONAL, Collective, collective

aten = torch.ops.aten

_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
         aten.baddbmm.default}
_GATHERS = {aten.embedding.default, aten.index.Tensor, aten.gather.default,
            aten.index_select.default, aten.take_along_dim.default}
_SCATTERS = {aten.index_put_.default, aten.index_put.default,
             aten.scatter.src, aten.scatter_.src, aten.scatter_add.default,
             aten.scatter_add_.default, aten.index_add.default,
             aten.index_add_.default}
_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "sin",
                   "cos", "erf", "logsumexp", "softplus", "log_softmax",
                   "_softmax", "exp_", "tanh_", "reciprocal", "reciprocal_"}


@dataclasses.dataclass
class CostReport:
    flops: float
    hbm_bytes: float
    coll_wire_bytes: float
    coll_wire_bytes_bf16: float
    coll_by_kind: dict
    dot_count: float
    unknown_loops: int
    loop_comps: dict[str, float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_prop() -> bool:
    """Whether DTensor's sharding propagation is running the op (on
    global shapes, to learn its output's shape)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _dot_flops(func, args) -> float:
    if func is aten.mm.default:
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if func is aten.addmm.default:
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is aten.bmm.default else (args[1],
                                                                 args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _group_size(name: str, args) -> int:
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class StepCost(TorchDispatchMode):
    """Counts rank 0's local program while a step runs under it (with
    ``kernels._ext.cost_sink(cost.kernel)`` installed beside it for the
    hand-written kernels).  ``report()`` -> ``CostReport``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm = 0.0
        self.dots = 0
        self.transcendentals = 0.0
        self.ops: dict[str, int] = defaultdict(int)
        self.kernels: dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self.collectives: list[Collective] = []
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}
        self.outputs = None   # what the traced step returned

    # ---------------------------------------------------------- memory
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def track(self, tree) -> int:
        """Count the local storages of ``tree``'s tensors (a DTensor's
        local shard) as live from now -> their bytes."""
        n0 = self.live
        for t in _tensors(tree):
            self._hold(t.to_local() if hasattr(t, "to_local") else t)
        return self.live - n0

    # ---------------------------------------------------------- kernels
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels[name]
        k[0] += 1
        k[1] += flops
        k[2] += nbytes
        self.flops += flops
        self.hbm += nbytes

    # ---------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _in_sharding_prop():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        short = name.split("::")[-1]
        ns = name.split("::")[0]
        self.ops[short] += 1
        if ns == "_c10d_functional":
            kind = FUNCTIONAL.get(short)
            if kind is not None:
                outs = list(_tensors(out))
                self.collectives.append(collective(
                    kind, str(outs[0].dtype).replace("torch.", ""),
                    sum(_nbytes(t) for t in outs),
                    _group_size(short, args), short))
            for t in _tensors(out):
                self._hold(t)
            return
        rets = func._schema.returns
        view = bool(rets) and rets[0].alias_info is not None and \
            not rets[0].alias_info.is_write
        outs = list(_tensors(out))
        for t in outs:
            self._hold(t)
        if view or short.startswith(("empty", "new_empty")) or \
                short in ("detach", "lift_fresh", "_local_scalar_dense"):
            return
        if func in _DOTS:
            self.flops += _dot_flops(func, args)
            self.dots += 1
        if short in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        res = sum(_nbytes(t) for t in outs)
        if func in _GATHERS:
            self.hbm += 2.0 * res
        elif func in _SCATTERS:
            # the values or source written: each op's last tensor operand
            self.hbm += 3.0 * _nbytes(list(_tensors(args))[-1])
        else:
            ins = list(_tensors(args)) + list(_tensors(kwargs))
            self.hbm += res + sum(_nbytes(t) for t in ins)

    def report(self) -> CostReport:
        from repro_torch.launch.collectives import summarize_collectives

        s = summarize_collectives(self.collectives)
        return CostReport(
            flops=self.flops, hbm_bytes=self.hbm,
            coll_wire_bytes=s["total"]["wire_bytes"],
            coll_wire_bytes_bf16=s["total"]["wire_bytes_bf16"],
            coll_by_kind=s["by_kind"], dot_count=float(self.dots),
            unknown_loops=0, loop_comps={})


def trace_step(fn, args, *, track=()) -> StepCost:
    """Run ``fn(*args)`` under ``StepCost`` with the kernels' cost sink,
    the tensors of ``track`` (the step's inputs) live from the start ->
    the filled ``StepCost``."""
    from repro_torch.kernels import _ext

    cost = StepCost()
    cost.track(track)
    with cost, _ext.cost_sink(cost.kernel):
        cost.outputs = fn(*args)
    return cost
