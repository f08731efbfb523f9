"""Sharded packet serving: each micro-batch split across shards
(counterpart of ``repro.serve.sharded``).

``ShardedPacketServeEngine`` extends ``PacketServeEngine``; a shard is
one entry of ``devices`` and holds the pipeline compiled for that device
(compiled once per distinct device and shared by its shards: the kernels
hold no state) and, for a stateful pipeline, a register table of its own.

* **Stateless programs** split every fixed-shape micro-batch evenly:
  shard *d* serves the contiguous rows ``[d*b, (d+1)*b)``, so verdict
  order is arrival order and each shard runs the single-device program.

* **Stateful programs** keep one private table per shard (a
  ``FlowState``, or a ``MitigatedFlowState`` when the pipeline ends in
  ``Mitigate``) and route packets by flow key on the host:
  ``FlowKey.apply_keys_np``, then ``shard_of_key`` (a second
  multiplicative mix of the flow key, independent of the in-table slot
  hash), then ``route_prefix``.  The arrival-order prefix that fits every
  shard's sub-batch goes out; the rest is pushed back to the queue head
  (counted in ``serve_route_overflow_total``), so per-flow update order is
  arrival order exactly.  Each shard's rows are a view of one pinned
  ``[n, b, F]`` staging buffer, copied to its device on that device's
  current stream; its verdicts come back into a pinned ``[n, b]`` ring
  behind one event per shard and are scattered back to arrival positions
  when fetched (``_unshard``).  The dispatch makes no host sync.  A flow's
  detection row and action row key on the same flow key, so both live on
  the same shard (docs/pipeline_ir.md#mitigation-contract).

* The engine **degrades** to the base engine's serving path, with
  ``stats()["shards"] == 1``, where the reference's does: fewer devices
  than ``min_shards``, a bare callable, or a multi-table pipeline (its
  tables key the same packet differently, so no one shard holds a flow).

A device may be listed more than once: each entry is a shard with its
own table, as the reference's engine serves on virtual host devices
(``--xla_force_host_platform_device_count``).  So ``["cpu"] * n`` serves
n shards on the CPU and ``["cuda:0"] * n`` n shards on one card.

Hot swap keeps the engine sharded: a bare callable, a multi-table
pipeline or a changed ``FlowKey.key_cols`` (the shard a flow lives on is
a function of its key) raises ``ValueError`` and the old pipeline serves
on.  Otherwise each shard's table carries over through the new
pipeline's ``adopt_state``: bit for bit for the same specs, re-keyed per
shard through ``migrate_state`` / ``migrate_mitigation`` for changed
ones; ``Mitigate`` swapped in starts empty action tables.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import stageir
from repro_torch.device import resolve_device
from repro_torch.flowstate.registers import hash_slot_np
from repro_torch.serve.packet_engine import (
    PacketServeEngine,
    _InFlight,
    _is_program,
)

# key-partitioned hashing: mix the (already FNV-folded) flow key once more
# with a Knuth multiplicative constant and take high bits, so the shard
# index stays independent of the table's slot index (hash & (S-1)) and a
# skewed low-bit key pattern cannot pile flows onto one shard
_SHARD_MIX = np.uint32(0x9E3779B1)


def shard_of_key(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """[B] int32 flow keys -> [B] shard ids in [0, n_shards)."""
    with np.errstate(over="ignore"):
        mixed = keys.astype(np.uint32) * _SHARD_MIX
    return ((mixed >> np.uint32(16)) % np.uint32(n_shards)).astype(np.int64)


def route_prefix(shard_ids: np.ndarray, n_shards: int, capacity: int
                 ) -> tuple[int, list]:
    """Largest arrival-order prefix that fits per-shard ``capacity``.

    Returns ``(m, perm)``: the first ``m`` rows fit, and ``perm[s]`` lists
    the original row indices (ascending = arrival order) that shard ``s``
    serves.  Row ``m`` is the first whose shard is already full — rows
    behind it must wait so per-flow order never inverts."""
    ranks = np.empty(len(shard_ids), np.int64)
    for s in range(n_shards):
        mask = shard_ids == s
        ranks[mask] = np.arange(int(mask.sum()))
    over = ranks >= capacity
    m = int(np.argmax(over)) if over.any() else len(shard_ids)
    ids = shard_ids[:m]
    perm = [np.flatnonzero(ids == s) for s in range(n_shards)]
    return m, perm


@dataclasses.dataclass
class ShardedFlowState:
    """One live table per shard, each on its shard's device: a
    ``FlowState``, or a ``MitigatedFlowState`` (the action table beside
    it).  ``keys``, ``regs``, ``mit_keys`` and ``mit_regs`` read the
    tables as ``[D, ...]`` stacks copied to the host, as the reference's
    stacked arrays read (``mit_*`` None without mitigation)."""

    tables: list

    @property
    def spec(self):
        return self.tables[0].spec

    @property
    def mit_spec(self):
        return getattr(self.tables[0], "mit_spec", None)

    @property
    def n_shards(self) -> int:
        return len(self.tables)

    def _stack(self, name: str):
        if name.startswith("mit_") and self.mit_spec is None:
            return None
        return torch.stack([getattr(t, name).cpu() for t in self.tables])

    @property
    def keys(self) -> torch.Tensor:
        return self._stack("keys")

    @property
    def regs(self) -> torch.Tensor:
        return self._stack("regs")

    @property
    def mit_keys(self):
        return self._stack("mit_keys")

    @property
    def mit_regs(self):
        return self._stack("mit_regs")

    @property
    def occupied(self) -> int:
        return sum(int((t.keys >= 0).sum()) for t in self.tables)

    @property
    def mitigated_flows(self) -> int:
        """Marked action-table slots across every shard."""
        if self.mit_spec is None:
            return 0
        return sum(t.mitigated_flows for t in self.tables)

    def arrays(self) -> tuple:
        """Each shard's state tensors, in step argument order: (keys,
        regs) or (keys, regs, mit_keys, mit_regs), one tuple per shard."""
        if self.mit_spec is None:
            return tuple((t.keys, t.regs) for t in self.tables)
        return tuple((t.keys, t.regs, t.mit_keys, t.mit_regs)
                     for t in self.tables)

    def with_arrays(self, arrays: tuple) -> "ShardedFlowState":
        """Rebuild around fresh per-shard tensors (``arrays()``'s form)."""
        return ShardedFlowState([
            dataclasses.replace(t, keys=a[0], regs=a[1], **(
                {"mit_keys": a[2], "mit_regs": a[3]} if len(a) > 2 else {}))
            for t, a in zip(self.tables, arrays)])


class _ShardedProgram:
    """A pipeline compiled once per distinct device, each shard holding
    its device's: what the engine serves (and an in-flight batch holds)
    as its ``pipeline``."""

    def __init__(self, by_device: dict, devices: list):
        self.shards = [by_device[d] for d in devices]
        head = self.shards[0]
        self.backend = head.backend
        self.stages = getattr(head, "stages", None)
        self.spec = getattr(head, "spec", None)
        self.mitigation = getattr(head, "mitigation", None)
        self.fallback_reason = getattr(head, "fallback_reason", None)

    def init_state(self) -> ShardedFlowState:
        return ShardedFlowState([p.init_state() for p in self.shards])

    def adopt_state(self, state: ShardedFlowState) -> ShardedFlowState:
        """Each shard's table into its pipeline's state shape
        (``StatefulPipeline.adopt_state``, shard by shard)."""
        return ShardedFlowState([p.adopt_state(t) for p, t in
                                 zip(self.shards, state.tables)])


class _Events(list):
    """The per-shard events of one batch, waited for together."""

    def synchronize(self) -> None:
        for e in self:
            e.synchronize()


def _on(dev: torch.device):
    """Make ``dev`` current (its current stream takes the launches)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _flow_key(pipeline) -> stageir.FlowKey:
    return next(s for s in pipeline.stages if isinstance(s, stageir.FlowKey))


class ShardedPacketServeEngine(PacketServeEngine):
    """``PacketServeEngine`` that serves each micro-batch across shards.

    ``devices`` (default: every visible CUDA device) lists one shard per
    entry; a device may repeat.  ``max_batch`` is rounded up to a multiple
    of the shard count, the sub-batch of a shard being ``max_batch / n``.
    ``min_shards`` is the degradation threshold: with fewer devices the
    engine serves exactly as the base class on ``devices[0]``.  ``state``
    resumes a ``ShardedFlowState`` with one table per shard.  Cross-flow
    order across shards is not defined (each table sees only its flows);
    per-flow update order is arrival order, the single-table guarantee
    per flow."""

    def __init__(self, pipeline, *, feature_dim: int, max_batch: int = 256,
                 backend: str | None = None, state=None, depth: int = 2,
                 devices=None, min_shards: int = 2, telemetry=None):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if len({d.type for d in self.devices}) > 1:
            raise ValueError("the shards' devices must all be CUDA devices "
                             f"or all the CPU, got {self.devices}")
        n = len(self.devices)
        self.sharded = (n >= max(1, int(min_shards))
                        and _is_program(pipeline)
                        and getattr(pipeline, "n_tables", 1) <= 1)
        self.n_shards = n if self.sharded else 1
        kw = dict(feature_dim=feature_dim, backend=backend, state=state,
                  depth=depth, telemetry=telemetry,
                  device=self.devices[0] if self.devices else "cuda")
        if not self.sharded:
            super().__init__(pipeline, max_batch=max_batch, **kw)
            return
        if state is not None and getattr(state, "n_shards", None) != n:
            raise ValueError(f"state= must be a ShardedFlowState of {n} "
                             "tables, one per shard")
        self._sub_batch = -(-int(max_batch) // n)       # ceil
        super().__init__(pipeline, max_batch=self._sub_batch * n, **kw)
        self._serve_devices = list(dict.fromkeys(
            d for d in self.devices if d.type == "cuda"))
        if self._stateful:
            self._flowkey = _flow_key(self.pipeline)
        self.stats_.shards = n
        if self._tel is not None:
            self._tel.metrics.gauge(
                "serve_shards", "shards serving").default.set(n)

    # ------------------------------------------------------- compilation

    def _compiled(self, pipeline, backend, device=None):
        """One compiled pipeline per distinct device, as a
        ``_ShardedProgram``; refuses what would leave the engine unable to
        shard (reachable only by a swap: construction degrades)."""
        if not self.sharded or device is not None:
            return super()._compiled(pipeline, backend, device)
        if not _is_program(pipeline):
            raise ValueError(
                "cannot hot-swap an untraceable pipeline (a bare callable: "
                "no stage list to compile per shard) into a sharded engine")
        if getattr(pipeline, "n_tables", 1) > 1:
            raise ValueError(
                "cannot hot-swap a multi-table pipeline into a sharded "
                "engine (flows are key-partitioned on ONE flow key)")
        by_device = {}
        for d in self.devices:
            if d not in by_device:
                by_device[d] = super()._compiled(pipeline, backend, d)
        return _ShardedProgram(by_device, self.devices)

    def _warm_up(self, pipeline, state) -> list:
        """One all-padding sub-batch per distinct device, on a shard's
        table of ``state`` (left unchanged) -> the ``[n * b, ...]`` verdict
        ring."""
        if not self.sharded:
            return super()._warm_up(pipeline, state)
        b = self._sub_batch
        zeros = torch.zeros((b, self.feature_dim))
        valid = torch.zeros(b, dtype=torch.int32)
        seen = set()
        for s, dev in enumerate(self.devices):
            if dev in seen:
                continue
            seen.add(dev)
            p = pipeline.shards[s]
            with _on(dev):
                out = p.dispatch(zeros) if state is None else \
                    p.dispatch(state.tables[s], zeros, valid)[1]
            out = out.cpu()
        return self._ring((self.max_batch, *out.shape[1:]), out.dtype)

    # ----------------------------------------------------------- serving

    def _dispatch_batch(self, rows: np.ndarray) -> int:
        if self.sharded and self._stateful:
            return self._dispatch_routed(rows)
        return super()._dispatch_batch(rows)

    def _dispatch_routed(self, rows: np.ndarray) -> int:
        """Stateful sharding: route rows to their flow's shard; the
        overflow goes back to the queue head -> rows dispatched."""
        self._maybe_install_swap()     # dispatch-ring boundary
        n, b = self.n_shards, self._sub_batch
        keys = self._flowkey.apply_keys_np(rows)
        shard_ids = shard_of_key(keys, n)
        m, perm = route_prefix(shard_ids, n, b)
        if m < len(rows):
            if self._tel is not None:
                self._tm["overflow"].inc(len(rows) - m)
            self._requeue_front(rows[m:].copy())
            rows = rows[:m]
        buf, valid, i = self._next_staging()
        x = buf.numpy().reshape(n, b, self.feature_dim)
        v = valid.numpy().reshape(n, b)
        x[:] = 0.0
        v[:] = 0
        for s, idx in enumerate(perm):
            x[s, :len(idx)] = rows[idx]
            v[s, :len(idx)] = 1
        slots = None
        if self._tel is not None:
            slots = False              # sampled out unless the tick fires
            if self._tel_flowkey is not None and self._seg_tick():
                # fold the shard id into the slot, so same-slot chains on
                # different shards never merge (each walks its own table)
                slots = (shard_ids[:m] * self._tel_slots
                         + hash_slot_np(keys[:m], self._tel_slots))
        return self._dispatch_staged(rows, m, buf, valid, i, perm=perm,
                                     slots=slots)

    def _launch(self, buf, valid, i: int):
        """Each shard's sub-batch on its device's current stream, its
        verdicts copied into its part of slot ``i`` of the verdict ring
        behind an event of its own; no host sync."""
        if not self.sharded:
            return super()._launch(buf, valid, i)
        b = self._sub_batch
        host = self._out_staging[i]
        cuda = self.device.type == "cuda"
        events, tables = _Events(), []
        for s, dev in enumerate(self.devices):
            p = self.pipeline.shards[s]
            rows = slice(s * b, (s + 1) * b)
            with _on(dev):
                if self._stateful:
                    table, out = p.dispatch(self.state.tables[s], buf[rows],
                                            valid[rows])
                    tables.append(table)
                else:
                    out = p.dispatch(buf[rows])
                host[rows].copy_(out, non_blocking=cuda)
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record()
        if self._stateful:
            self.state = ShardedFlowState(tables)
        return host, (events if cuda else None)

    def _unshard(self, v: np.ndarray, f: _InFlight) -> np.ndarray:
        """Scatter per-shard outputs (verdicts, or feature rows when the
        classifier suffix emits vectors) back to arrival positions."""
        v = v.reshape(self.n_shards, self._sub_batch, *v.shape[1:])
        out = np.empty((f.n,) + v.shape[2:], v.dtype)
        for s, idx in enumerate(f.perm):
            out[idx] = v[s, :len(idx)]
        return out

    # ---------------------------------------------------------- hot swap

    def _prepare_swap(self, pipeline) -> list:
        if self.sharded and self._stateful:
            new, old = _flow_key(pipeline).key_cols, self._flowkey.key_cols
            if tuple(new) != tuple(old):
                raise ValueError(
                    "sharded hot swap must preserve FlowKey.key_cols "
                    "(flows are key-partitioned across shards): "
                    f"{tuple(old)} -> {tuple(new)}")
        return super()._prepare_swap(pipeline)

    def _install_swap(self, pipeline, ring) -> None:
        super()._install_swap(pipeline, ring)
        if self.sharded and self._stateful:
            self._flowkey = _flow_key(pipeline)
