"""Micro-batching packet-serving engine (counterpart of
``repro.serve.packet_engine.PacketServeEngine``) over one compiled
program: a stateful ``flowstate.StatefulPipeline``, a
``chaining.CompiledDag``, a ``stageir.CompiledStages`` or anything with a
stateless ``.stages`` list (compiled by ``compile_stages``) — or a bare
``[n, F] -> verdicts`` callable, served as given (``state=`` makes it
``(state, X, valid) -> (state, verdicts)``), as the reference serves one.

Incoming packets are cut into batches of a FIXED shape ``max_batch``;
ragged tails are padded with zero rows and their verdicts are sliced
off.  A stateful pipeline also gets them as ``valid=0`` rows, which never
touch the register file.  Verdicts come back in arrival order at any
``depth``.

Overlap: up to ``depth`` batches stay in flight.  Each batch is staged in
one of ``depth+1`` pinned host buffers, copied to the card and dispatched
on the current stream without waiting; its verdicts are copied back into
a pinned buffer behind a CUDA event, and only ``flush()``/stream
consumption waits on that event.  Successive batches chain through the
register state on one stream, so overlap never reorders updates.  The
stateless dispatch makes no host sync either.  A
staging buffer is refilled only after the batch that used it was
fetched, so an in-flight copy never reads a buffer being written.

``ServeStats`` separates host dispatch time (``dispatch_s``) from
per-batch latency (dispatch -> verdicts on the host) and counts
``wall_s`` as the active serving span, overlapping windows merged.
``mitigated`` counts the ``MITIGATED`` verdicts of a pipeline with an
action table.

Hot swap (``swap``): the new pipeline is built and warmed on the
caller's thread, parked, and installed at the next dispatch-ring
boundary (the top of a dispatch, or the end of a flush), so in-flight
batches finish on the old pipeline and no batch is dropped or
reordered.  The live state carries over through the new pipeline's
``adopt_state``: bit-identically for the same specs, re-keyed through
``migrate_state``/``migrate_mitigation`` for changed ones; adding a
``Mitigate`` starts an empty action table, dropping one drops it.  A
stateless engine swaps between stateless programs; a swap that changes
statefulness raises.  ``stats()`` records each swap's latency (request
to install) and the packet offset of its boundary.

Telemetry (``telemetry=``, ``engine.telemetry()``): the reference's
observability plane, copied in ``repro_torch.telemetry``, with the
reference's metric names, help strings and journal event kinds.  It
records on the host at dispatch-ring boundaries only: per-batch counters,
histograms and the dispatch span; the slot-segmentation statistics of
every ``TELEMETRY_SEG_SAMPLE``-th batch, recomputed from the host staging
rows (table 0's flow key); batch latency and mitigated packets when a
batch is fetched; hot-swap and ``backend_fallback`` journal events; and
a table-health scan at each flush, which copies table 0's key vector
(and the action table) to the host where the engine waits on the card
anyway.  The dispatch reads no device tensor for it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.core import stageir
from repro_torch.device import resolve_device
from repro_torch.flowstate.mitigation import MITIGATED
from repro_torch.flowstate.registers import hash_slot_np


@dataclasses.dataclass
class ServeStats:
    packets: int = 0
    batches: int = 0
    pad_packets: int = 0           # zero rows added to fill fixed shapes
    backend_counts: dict = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0            # active serving span (overlap merged)
    dispatch_s: float = 0.0        # host time staging + launching batches
    backend: str = "interpret"     # engine the pipeline actually runs on
    depth: int = 1                 # in-flight cap
    mitigated: int = 0             # MITIGATED verdicts returned
    shards: int = 1                # shards serving (ShardedPacketServeEngine)
    # hot swaps: latency (request -> install) and the packet offset of
    # each boundary (packets before it served by the old pipeline)
    swaps: int = 0
    swap_lat_s: list = dataclasses.field(default_factory=list)
    swap_pkt_offsets: list = dataclasses.field(default_factory=list)
    # trailing window of per-batch latencies (dispatch -> verdicts on host)
    batch_lat_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=ServeStats.LAT_WINDOW)
    )

    LAT_WINDOW = 4096

    @property
    def pkt_per_s(self) -> float:
        if self.batches == 0:
            return 0.0
        return self.packets / max(self.wall_s, 1e-9)

    def _lat_ms(self, q: float) -> float:
        if not self.batch_lat_s:
            return 0.0
        return float(np.percentile(np.asarray(self.batch_lat_s), q)) * 1e3

    @property
    def lat_p50_ms(self) -> float:
        return self._lat_ms(50)

    @property
    def lat_p95_ms(self) -> float:
        return self._lat_ms(95)

    @property
    def lat_p99_ms(self) -> float:
        return self._lat_ms(99)

    @property
    def backend_batches(self) -> dict:
        """Batch count per serving engine."""
        return dict(self.backend_counts)

    def count_batch(self, backend: str, n: int, pad: int = 0) -> None:
        self.batches += 1
        self.packets += n
        self.pad_packets += pad
        self.backend_counts[backend] = \
            self.backend_counts.get(backend, 0) + 1

    def record_swap(self, lat_s: float) -> None:
        self.swaps += 1
        self.swap_lat_s.append(float(lat_s))
        self.swap_pkt_offsets.append(int(self.packets))

    def as_dict(self) -> dict:
        return {
            "packets": self.packets,
            "batches": self.batches,
            "pad_packets": self.pad_packets,
            "wall_s": self.wall_s,
            "dispatch_s": self.dispatch_s,
            "pkt_per_s": self.pkt_per_s,
            "lat_p50_ms": self.lat_p50_ms,
            "lat_p95_ms": self.lat_p95_ms,
            "lat_p99_ms": self.lat_p99_ms,
            "backend": self.backend,
            "backend_batches": self.backend_batches,
            "depth": self.depth,
            "shards": self.shards,
            "mitigated": self.mitigated,
            "swaps": self.swaps,
            "swap_lat_ms": [s * 1e3 for s in self.swap_lat_s],
            "swap_pkt_offsets": list(self.swap_pkt_offsets),
        }


@dataclasses.dataclass
class _InFlight:
    """One dispatched batch whose verdicts are not fetched yet."""

    n: int                         # real (non-padding) rows
    out: torch.Tensor              # host tensor the verdicts land in
    t0: float                      # dispatch start
    event: Any                     # waits for the copy (``synchronize()``)
    ready: float | None            # completion time when known at dispatch
    mitigated: bool = False        # served by a pipeline with Mitigate
    # the pipeline that served it, alive until its verdicts are fetched:
    # one a swap retires is freed only after the card has finished with
    # it, whichever stream its tensors were allocated on
    pipeline: Any = None
    perm: Any = None               # sharded routing: per-shard row indices


class _Callable:
    """A bare callable served as given: it has no stage list to lower, so
    it reports ``"interpret"``, as the reference's engine reports one.
    It gets the host batch as a CPU tensor (``.numpy()`` views it without
    a copy) and may return numpy or a tensor on any device."""

    backend = "interpret"

    def __init__(self, fn):
        self.fn = fn

    def dispatch(self, *args):
        """(X) -> verdicts, or (state, X, valid) -> (state, verdicts)."""
        out = self.fn(*args)
        if len(args) == 1:
            return _verdicts(out)
        state, out = out
        return state, _verdicts(out)


def _verdicts(out) -> torch.Tensor:
    return out if isinstance(out, torch.Tensor) \
        else torch.as_tensor(np.asarray(out))


def _is_program(pipeline) -> bool:
    """A program the port compiles (as opposed to a bare callable)."""
    return hasattr(pipeline, "with_backend") or hasattr(pipeline, "stages")


def _bare(fn, backend: str | None) -> _Callable:
    """A bare callable for the engine.  The reference degrades any
    requested backend to serving it as given; the port serves it so for
    None and "interpret" and refuses "cuda", which it cannot honour
    without a stage list (no quiet fallback)."""
    if backend == "cuda":
        raise ValueError("backend='cuda' lowers a stage list onto the "
                         "port's kernels; a bare callable has none (serve "
                         "it with backend=None or 'interpret')")
    if backend not in (None, *stageir.EXEC_BACKENDS):
        raise KeyError(f"backend must be one of {stageir.EXEC_BACKENDS}")
    return _Callable(fn)


def _stateless(pipeline, backend: str | None, device: torch.device):
    """A stateless program compiled for ``backend`` (None: as it was
    asked) on ``device``, as it is when neither differs: a ``CompiledDag``
    recompiles itself; a ``CompiledStages`` or anything else with
    ``.stages`` goes through ``compile_stages``."""
    if hasattr(pipeline, "with_backend"):             # chaining.CompiledDag
        if backend is None and pipeline.device == device:
            return pipeline
        return pipeline.with_backend(backend or pipeline.requested_backend,
                                     device=device)
    if isinstance(pipeline, stageir.CompiledStages) and backend is None \
            and pipeline.device == device:
        return pipeline
    return stageir.compile_stages(
        pipeline.stages, fuse=getattr(pipeline, "fuse", True),
        backend=backend or getattr(pipeline, "requested_backend",
                                   "interpret"), device=device)


class PacketServeEngine:
    """Micro-batching front end over one compiled program or a bare
    callable.

    ``backend`` (``"interpret"`` | ``"cuda"``) recompiles the pipeline for
    that engine (a ``StatefulPipeline`` keeps its ``fuse`` flag; a bare
    callable is served as given and refuses ``"cuda"``);
    ``device`` (default ``"cuda"``) is where it serves — a pipeline built
    for another device is recompiled for this one.  ``state`` resumes an
    existing register file of a stateful pipeline (on the card the engine
    then updates its tensors in place); None starts empty.  ``depth``
    batches stay in flight.  ``telemetry``: None or True creates an
    enabled ``repro_torch.telemetry.Telemetry``, False disables
    recording, an instance is shared; ``telemetry()`` returns it."""

    # the slot segmentation of every Nth batch (the first included) is
    # recomputed on the host for the telemetry, as in the reference
    # engine; tests set 1 for exact counts
    TELEMETRY_SEG_SAMPLE = 8

    def __init__(self, pipeline, *, feature_dim: int, max_batch: int = 256,
                 backend: str | None = None, state=None, depth: int = 2,
                 device="cuda", telemetry=None):
        dev = resolve_device(device)
        self._stateful = state is not None or hasattr(pipeline, "init_state")
        self.device = dev
        # the devices whose current streams serve (a swap's hand-off
        # event is recorded and waited on each)
        self._serve_devices = [dev] if dev.type == "cuda" else []
        self.pipeline = self._compiled(pipeline, backend)
        self.backend = self.pipeline.backend
        self.feature_dim = int(feature_dim)
        self.max_batch = int(max_batch)
        self.depth = max(1, int(depth))
        self.state = None
        if self._stateful:
            self.state = state if state is not None \
                else self.pipeline.init_state()
        self._queue: collections.deque[np.ndarray] = collections.deque()
        self._pending = 0
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # depth+1 staging slots: the one being filled is never one an
        # in-flight batch may still be copying from
        self._staging = self._ring((self.max_batch, self.feature_dim),
                                   torch.float32)
        self._valid_staging = self._ring((self.max_batch,), torch.int32)
        self._staging_i = 0
        self._mark: float | None = None
        self._swap_lock = threading.Lock()
        self._pending_swap: tuple | None = None
        self.stats_ = ServeStats(backend=self.backend, depth=self.depth)
        self._init_telemetry(telemetry, backend)
        if self._tel is not None:
            with self._tel.tracer.span("warm_up", cat="compile",
                                       backend=self.backend):
                self._out_staging = self._warm_up(self.pipeline, self.state)
        else:
            self._out_staging = self._warm_up(self.pipeline, self.state)

    # --------------------------------------------------------- telemetry

    def telemetry(self):
        """The attached ``repro_torch.telemetry.Telemetry`` (None when
        constructed with ``telemetry=False``)."""
        return self._tel

    def _init_telemetry(self, telemetry, requested_backend) -> None:
        """Resolve the plane and bind every per-batch handle once, so a
        batch records with a few attribute adds."""
        self._tel = T.resolve(telemetry)
        self._tel_flowkey = None
        self._tel_slots = 0
        self._backend_children: dict = {}
        self._health_keys = None       # the previous flush's key vector
        self._health_marked = 0        # the previous marked-flow count
        self._seg_n = 0                # segmentation sampling tick
        if self._tel is None:
            return
        m = self._tel.metrics
        self._tm = {
            "packets": m.counter(
                "serve_packets_total", "real packets dispatched").default,
            "batches": m.counter(
                "serve_batches_total", "micro-batches dispatched").default,
            "pad": m.counter(
                "serve_pad_packets_total",
                "zero rows added to fill fixed batch shapes").default,
            "swaps": m.counter(
                "serve_swaps_total", "hot swaps installed").default,
            "mitigated": m.counter(
                "serve_mitigated_packets_total",
                "packets dropped/limited by the action table").default,
            "dispatch_ms": m.histogram(
                "serve_dispatch_ms",
                "host time staging + launching one batch").default,
            "batch_lat_ms": m.histogram(
                "serve_batch_latency_ms",
                "dispatch -> result ready, per batch").default,
            "swap_lat_ms": m.histogram(
                "serve_swap_latency_ms",
                "swap request -> ring-boundary install").default,
            # the lockstep/drain split is the reference's traffic-shape
            # signal, names and help text kept for its dashboards; the
            # port's K1 walks every chain and has neither schedule
            "lockstep": m.counter(
                "flow_lockstep_batches_total",
                "sampled stateful batches retired mostly by the "
                "compacted lockstep rounds").default,
            "drain": m.counter(
                "flow_drain_batches_total",
                "sampled stateful batches with a drain-heavy traffic "
                "shape (served in-kernel by the compacted drain)").default,
            "deep_pkts": m.counter(
                "flow_deep_packets_total",
                "packets deeper than PAR_ROUNDS in a same-slot chain "
                "(sampled batches)").default,
            "max_chain": m.gauge(
                "flow_batch_max_chain",
                "deepest same-slot chain of the last dispatched batch"
            ).default,
            "overflow": m.counter(
                "serve_route_overflow_total",
                "rows pushed back to the queue head because their "
                "shard's sub-batch filled (sharded routing)").default,
        }
        self._backend_counter = m.counter(
            "serve_backend_batches_total",
            "batches per execution backend actually serving")
        m.gauge("serve_depth", "dispatch-pipeline depth").default.set(
            self.depth)
        self._resolve_flow_telemetry(self.pipeline)
        self._journal_fallback(self.pipeline, requested_backend)

    def _journal_fallback(self, pipeline, requested, **during) -> None:
        """A ``backend_fallback`` event when ``backend="cuda"`` was asked
        for and a plain part serves ("interpret" or "mixed"), or the
        pipeline carries a decline reason."""
        reason = getattr(pipeline, "fallback_reason", None)
        actual = pipeline.backend
        if reason or (requested == "cuda"
                      and actual in ("interpret", "mixed")):
            ev = {"requested": requested or "cuda", "actual": actual,
                  "engine": type(self).__name__, **during}
            if reason:
                ev["reason"] = reason
            self._tel.journal.emit("backend_fallback", **ev)

    def _resolve_flow_telemetry(self, pipeline) -> None:
        """Take the pipeline's first FlowKey (table 0's) so the batch
        segmentation can be recomputed from the host rows."""
        self._tel_flowkey = None
        if self._tel is None or not self._stateful \
                or not hasattr(pipeline, "spec"):
            return
        fk = next((s for s in pipeline.stages
                   if isinstance(s, stageir.FlowKey)), None)
        if fk is not None:
            self._tel_flowkey = fk
            self._tel_slots = int(pipeline.spec.n_slots)

    def _seg_tick(self) -> bool:
        """True on the sampled batches (every TELEMETRY_SEG_SAMPLE-th,
        the first included)."""
        self._seg_n += 1
        return self._seg_n % self.TELEMETRY_SEG_SAMPLE == 1 \
            or self.TELEMETRY_SEG_SAMPLE == 1

    def _record_dispatch(self, rows: np.ndarray, n: int, pad: int,
                         t0: float, t1: float, slots=None) -> None:
        """Per-batch recording from host data: counters, the dispatch
        span and, on sampled batches of a stateful pipeline, the slot
        segmentation of the real rows.  ``slots``: the real rows' slots
        when the caller has them (sharded routing holds the keys), None
        to compute them here on sampled batches, or False when the caller
        sampled the batch out."""
        tm = self._tm
        tm["packets"].inc(n)
        tm["batches"].inc(1)
        if pad:
            tm["pad"].inc(pad)
        child = self._backend_children.get(self.backend)
        if child is None:
            child = self._backend_children[self.backend] = \
                self._backend_counter.labels(backend=self.backend)
        child.inc(1)
        tm["dispatch_ms"].observe((t1 - t0) * 1e3)
        self._tel.tracer.record(
            "dispatch", t0, t1,
            args={"backend": self.backend, "rows": n, "pad": pad})
        if self._tel_flowkey is None or slots is False:
            return
        if slots is None:
            if not self._seg_tick():
                return
            slots = hash_slot_np(self._tel_flowkey.apply_keys_np(rows),
                                 self._tel_slots)
        seg = T.batch_segmentation(slots)
        (tm["drain"] if seg["drain_heavy"] else tm["lockstep"]).inc(1)
        if seg["n_deep"]:
            tm["deep_pkts"].inc(seg["n_deep"])
        tm["max_chain"].set(seg["max_chain"])

    def _record_fetch(self, t0: float, end: float, n: int,
                      dropped: int) -> None:
        """A fetched batch: its latency, its span, its mitigated
        packets."""
        self._tm["batch_lat_ms"].observe((end - t0) * 1e3)
        self._tel.tracer.record("batch", t0, end,
                                args={"backend": self.backend, "rows": n})
        if dropped:
            self._tm["mitigated"].inc(dropped)

    def _scan_flow_health(self) -> None:
        """Flush-boundary scan of the live table (table 0's keys and the
        action table, copied to the host): occupancy, inserts and
        evictions since the previous scan, and the mitigation
        engage/release journal events."""
        if self._tel is None or not self._stateful or self.state is None:
            return
        h = T.table_health(self.state, self._health_keys)
        self._health_keys = h.pop("keys")
        m = self._tel.metrics
        m.gauge("flow_occupied_slots",
                "occupied register-file slots").default.set(h["occupied"])
        m.gauge("flow_occupancy_frac",
                "occupied / total slots").default.set(
            round(h["occupancy_frac"], 6))
        if h["inserts"]:
            m.counter("flow_inserts_total",
                      "slots going empty -> occupied between scans"
                      ).default.inc(h["inserts"])
        if h["evictions"]:
            m.counter("flow_evictions_total",
                      "occupied slots whose key changed between scans "
                      "(collision evictions)").default.inc(h["evictions"])
        if h["mit_slots"]:
            m.gauge("flow_mit_occupied",
                    "occupied action-table slots").default.set(
                h["mit_occupied"])
            m.gauge("flow_mit_marked",
                    "flows past the mitigation threshold").default.set(
                h["mit_marked"])
            delta = h["mit_marked"] - self._health_marked
            if delta:
                self._tel.journal.emit(
                    "mitigation_engage" if delta > 0
                    else "mitigation_release", flows=abs(delta),
                    marked=h["mit_marked"],
                    pkt_offset=int(self.stats_.packets))
            self._health_marked = h["mit_marked"]

    def _ring(self, shape, dtype) -> list:
        """depth+1 host buffers, pinned when serving on the card."""
        pinned = self.device.type == "cuda"
        return [torch.zeros(shape, dtype=dtype, pin_memory=pinned)
                for _ in range(self.depth + 1)]

    def _compiled(self, pipeline, backend, device=None):
        """``pipeline`` compiled for ``device`` (default: this engine's;
        and for ``backend`` when given); a bare callable as given."""
        dev = self.device if device is None else device
        if not _is_program(pipeline):
            return _bare(pipeline, backend)
        if not self._stateful:
            return _stateless(pipeline, backend, dev)
        if backend is not None or pipeline.device != dev:
            return pipeline.with_backend(
                backend or pipeline.requested_backend, device=dev)
        return pipeline

    def _warm_up(self, pipeline, state) -> list:
        """Build ``pipeline``'s kernels and run one all-padding batch on
        ``state`` (None for a stateless program; a register file is left
        unchanged), waited for, so serving time excludes the build ->
        the ring its verdicts are staged in, of their shape and dtype
        ([max_batch] int32 verdicts, or logits / concat verdicts), so the
        dispatch never allocates."""
        zeros = torch.zeros((self.max_batch, self.feature_dim))
        if state is None:
            out = pipeline.dispatch(zeros)
        else:
            _, out = pipeline.dispatch(
                state, zeros, torch.zeros(self.max_batch, dtype=torch.int32))
        out = out.cpu()
        return self._ring(tuple(out.shape), out.dtype)

    # ------------------------------------------------------------ intake

    def submit(self, packets: np.ndarray) -> None:
        """Enqueue a [n, F] chunk (copied: callers may reuse buffers)."""
        pkts = np.array(packets, np.float32)
        if pkts.ndim == 1:
            pkts = pkts[None, :]
        if pkts.shape[1] != self.feature_dim:
            raise ValueError(
                f"expected {self.feature_dim} features, got {pkts.shape[1]}")
        self._queue.append(pkts)
        self._pending += len(pkts)

    @property
    def pending(self) -> int:
        return self._pending

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    # ----------------------------------------------------------- serving

    def _take(self, n: int) -> np.ndarray:
        """Pop exactly n rows off the queue head (views where possible;
        a small residual of a large chunk is copied so the parent can go)."""
        taken, got = [], 0
        while got < n:
            head = self._queue[0]
            need = n - got
            if len(head) <= need:
                taken.append(self._queue.popleft())
                got += len(head)
            else:
                taken.append(head[:need])
                rest = head[need:]
                if len(rest) * 4 < len(head):
                    rest = rest.copy()
                self._queue[0] = rest
                got = n
        self._pending -= n
        return taken[0] if len(taken) == 1 else np.concatenate(taken, 0)

    def _requeue_front(self, rows: np.ndarray) -> None:
        """Push rows back to the queue head (the sharded overflow path):
        the next batch starts with them, so arrival order holds."""
        self._queue.appendleft(rows)
        self._pending += len(rows)

    def _next_staging(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """-> (rows buffer, valid buffer, ring index) of the next staging
        slot; the verdict ring's slot of the same index goes with it."""
        i = self._staging_i
        self._staging_i = (i + 1) % len(self._staging)
        return self._staging[i], self._valid_staging[i], i

    def _dispatch_batch(self, rows: np.ndarray) -> int:
        self._maybe_install_swap()            # dispatch-ring boundary
        n = len(rows)
        buf, valid, i = self._next_staging()
        b, v = buf.numpy(), valid.numpy()
        b[:n] = rows
        b[n:] = 0.0
        v[:n] = 1
        v[n:] = 0
        return self._dispatch_staged(rows, n, buf, valid, i)

    def _dispatch_staged(self, rows: np.ndarray, n: int, buf, valid, i: int,
                         *, perm=None, slots=None) -> int:
        """Launch a staged batch of ``n`` real rows and account for it;
        ``perm`` and ``slots`` as ``_InFlight.perm`` and
        ``_record_dispatch``'s."""
        pad = self.max_batch - n
        t0 = time.perf_counter()
        if not self._inflight:
            self._mark = t0
        host, event = self._launch(buf, valid, i)
        flight = _InFlight(n, host, t0, event,
                           None if event is not None else time.perf_counter(),
                           perm=perm)
        flight.mitigated = getattr(self.pipeline, "mitigation",
                                   None) is not None
        flight.pipeline = self.pipeline
        t1 = time.perf_counter()
        self.stats_.dispatch_s += t1 - t0
        self.stats_.count_batch(self.backend, n, pad)
        if self._tel is not None:
            self._record_dispatch(rows, n, pad, t0, t1, slots=slots)
        self._inflight.append(flight)
        return n

    def _launch(self, buf, valid, i: int):
        """One staged batch through the pipeline -> (the host tensor its
        verdicts land in, the event to wait on, or None when they are
        there already).  On the card the copy back goes into slot ``i``
        of the verdict ring behind an event; no host sync."""
        if self._stateful:
            self.state, out = self.pipeline.dispatch(self.state, buf, valid)
        else:
            out = self.pipeline.dispatch(buf)
        if self.device.type != "cuda":
            return out, None
        host = self._out_staging[i]
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _unshard(self, v: np.ndarray, f: _InFlight) -> np.ndarray:
        raise NotImplementedError      # ShardedPacketServeEngine only

    def _fetch_one(self) -> np.ndarray:
        """Materialise the oldest in-flight batch (FIFO: arrival order)."""
        f = self._inflight.popleft()
        if f.event is not None:
            f.event.synchronize()
        if f.perm is not None:
            out = self._unshard(f.out.numpy(), f)
        else:
            out = f.out.numpy()[:f.n].copy()
        dropped = int((out == MITIGATED).sum()) if f.mitigated else 0
        self.stats_.mitigated += dropped
        end = f.ready if f.ready is not None else time.perf_counter()
        self.stats_.batch_lat_s.append(end - f.t0)
        if self._mark is not None:
            self.stats_.wall_s += max(0.0, end - self._mark)
            self._mark = max(self._mark, end) if self._inflight else None
        if self._tel is not None:
            self._record_fetch(f.t0, end, f.n, dropped)
        return out

    def flush(self) -> np.ndarray:
        """Serve everything pending; verdicts in arrival order."""
        outs = []
        while self._pending:
            while len(self._inflight) >= self.depth:
                outs.append(self._fetch_one())
            self._dispatch_batch(
                self._take(min(self.max_batch, self._pending)))
        while self._inflight:
            outs.append(self._fetch_one())
        # the drained ring is a boundary: a parked swap never outlives a
        # flush, even when no more traffic arrives
        self._maybe_install_swap()
        self._scan_flow_health()
        if not outs:
            return np.zeros((0,), np.int32)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, 0)

    def serve_stream(self, chunks: Iterable[np.ndarray]
                     ) -> Iterator[np.ndarray]:
        """Yield verdicts per full batch as the stream arrives; the tail
        is flushed at the end.  With ``depth>1`` the next batch is
        dispatched before the previous result is consumed."""
        for chunk in chunks:
            self.submit(chunk)
            while self._pending >= self.max_batch:
                while len(self._inflight) >= self.depth:
                    yield self._fetch_one()
                self._dispatch_batch(self._take(self.max_batch))
        if self._pending or self._inflight:
            tail = self.flush()
            if len(tail):
                yield tail

    # ---------------------------------------------------------- hot swap

    def swap(self, pipeline, *, backend: str | None = None) -> None:
        """Install ``pipeline`` at the next dispatch-ring boundary.  It is
        recompiled for this engine's device (and for ``backend`` when
        given) and warmed here, on the caller's thread and current
        stream; the serving path only adopts it, its stream first waiting
        on the card for what the caller's stream wrote.  A swap that
        changes statefulness raises: that is a different engine, not a
        new model."""
        t_req = time.perf_counter()
        if hasattr(pipeline, "init_state") != self._stateful:
            old, new = (("stateful", "stateless") if self._stateful
                        else ("stateless", "stateful"))
            raise ValueError("hot swap cannot change statefulness: engine "
                             f"is {old}, new pipeline is {new}")
        pipeline = self._compiled(pipeline, backend)
        ring = self._prepare_swap(pipeline)
        # the hand-off: the install makes each serving stream wait for
        # this point of the stream the caller built and warmed the
        # pipeline on (a retrain worker's own), device by device
        ready = []
        for dev in self._serve_devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready.append((dev, ev))
        if self._tel is not None:
            self._tel.tracer.record(
                "swap_prepare", t_req, time.perf_counter(), cat="swap",
                args={"backend": pipeline.backend})
            self._journal_fallback(pipeline, backend, during="swap")
        with self._swap_lock:
            self._pending_swap = (pipeline, ring, t_req, ready)

    @property
    def swap_pending(self) -> bool:
        return self._pending_swap is not None

    def _prepare_swap(self, pipeline) -> list:
        """Warm ``pipeline`` on a throwaway state -> its verdict ring, so
        the install itself never builds or allocates anything."""
        return self._warm_up(pipeline, pipeline.init_state()
                             if self._stateful else None)

    def _maybe_install_swap(self) -> None:
        if self._pending_swap is None:        # the common case, lock-free
            return
        with self._swap_lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return
        pipeline, ring, t_req, ready = pending
        old_backend = self.backend
        t0 = time.perf_counter()
        for dev, ev in ready:
            torch.cuda.current_stream(dev).wait_event(ev)
        self._install_swap(pipeline, ring)
        t1 = time.perf_counter()
        lat_s = t1 - t_req
        self.stats_.record_swap(lat_s)
        if self._tel is not None:
            self._tm["swaps"].inc(1)
            self._tm["swap_lat_ms"].observe(lat_s * 1e3)
            self._tel.tracer.record(
                "swap_install", t0, t1, cat="swap",
                args={"from": old_backend, "to": self.backend})
            self._tel.journal.emit(
                "hot_swap", lat_ms=round(lat_s * 1e3, 3),
                pkt_offset=int(self.stats_.packets),
                old_backend=old_backend, new_backend=self.backend,
                engine=type(self).__name__)

    def _install_swap(self, pipeline, ring) -> None:
        if self._stateful:
            self._carry_state(pipeline)
        # in-flight batches hold their own slots of the old ring
        self._out_staging = ring
        self.pipeline = pipeline
        self.backend = pipeline.backend
        self.stats_.backend = self.backend
        # the segmentation follows the new pipeline's FlowKey and spec
        self._resolve_flow_telemetry(pipeline)

    def _carry_state(self, pipeline) -> None:
        """The live state into the new pipeline's shape: the same specs
        keep the tensors bit-identically, changed specs re-key (see
        ``StatefulPipeline.adopt_state``)."""
        self.state = pipeline.adopt_state(self.state)

    def stats(self) -> dict:
        return self.stats_.as_dict()
