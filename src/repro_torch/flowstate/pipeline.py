"""Stateful serving pipeline (counterpart of
``repro.flowstate.pipeline.StatefulPipeline``), single table, with an
optional trailing ``Mitigate`` action table.

Per fixed-shape batch it derives flow keys, updates the register file,
reads each packet's post-update row and classifies it; a ``Mitigate``
stage then feeds the verdicts to the action table and dropped packets
come back as ``MITIGATED``.  The state — (keys, regs), plus (mit_keys,
mit_regs) when mitigated — threads through as explicit tensors.  On the
card it is donated, as the JAX package donates it on accelerators: the
kernels update the given state's tensors in place, so a dispatched-into
state is consumed and callers adopt the returned one (the engine always
does).  On the CPU and under ``"interpret"`` the given state is never
written.

Backends, reported by ``backend`` as what actually serves:

  ``backend="cuda", fuse=True``   the single K1 launch per batch, the
                                  action table folded in
                                  (``"cuda-fused-flow"``);
  ``backend="cuda", fuse=False``  K2 for the registers, then K3 (MLP) or
                                  K4 (MAT) for the classifier
                                  (``"cuda"``).  Where the JAX package
                                  has no kernel either — the action table
                                  and a centroid classifier on the split
                                  path — the part runs its plain version
                                  on the pipeline's device (the action
                                  table as whole-batch tensor operations
                                  with no host sync), reported
                                  ``"interpret"``, and the whole
                                  ``"mixed"``, as the JAX package reports
                                  it;
  ``fuse=True`` is the default, but ``fuse=False`` is the faster choice
  once the MLP is too large for shared memory (K1 walks each slot chain
  one step at a time and runs the MLP at every step, its weights read
  through L2): on an H100 the design space's deepest classifier costs
  K1 about 40 times what K2 + K3 take per batch (PERF.md, the kernel
  table's rows 1e and 3a);
  ``backend="interpret"``         the plain stage walk: sequential
                                  register update + each stage's plain
                                  ``apply`` + the plain action-table walk
                                  (``"interpret"``).

On ``device="cpu"`` the cuda lowerings run the same ops, which take their
plain versions for CPU tensors; they report ``"cpu-ref-fused-flow"`` and
``"cpu-ref"`` (or ``"mixed"``).  ``backend="cuda"`` never walks a part
the JAX package has a kernel for: it raises with the reason
(``fallback_reason`` is therefore always None in the port).  A second
``FlowKey`` raises ``NotImplementedError``: multi-table pipelines are a
later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cuda_backend, stageir
from repro_torch.device import resolve_device
from repro_torch.flowstate.mitigation import (
    MitigatedFlowState,
    init_mitigation,
    migrate_mitigation,
)
from repro_torch.flowstate.registers import (
    FlowState,
    init_state,
    migrate_state,
)

EXEC_BACKENDS = stageir.EXEC_BACKENDS
REPORT_BACKENDS = stageir.REPORT_BACKENDS


class StatefulPipeline:
    """``state', verdicts = pipe(state, X, valid=None)`` for a [B, F]
    packet batch; ``valid`` masks ragged-batch padding rows, which never
    touch a table (their verdicts are meaningless)."""

    def __init__(self, stages, *, backend: str = "interpret",
                 fuse: bool = True, device="cuda"):
        if backend not in EXEC_BACKENDS:
            raise KeyError(f"backend must be one of {EXEC_BACKENDS}")
        self.device = resolve_device(device)
        self.stages = list(stages)
        self.requested_backend = backend
        self.fuse = bool(fuse)
        rest, mit = stageir.split_mitigation(self.stages)
        if sum(isinstance(s, stageir.FlowKey) for s in rest) > 1:
            raise NotImplementedError(
                "multi-table pipelines (several FlowKey/RegisterUpdate "
                "groups) are not yet ported; they come in a later slice")
        prefix, suffix = stageir.split_stateful(rest)
        self.spec = prefix[1].spec
        self.mitigation = mit.spec if mit is not None else None
        self.fallback_reason: str | None = None
        self.fused = backend == "cuda" and self.fuse
        base = stageir.kernel_backend(self.device)

        if self.fused:
            step = cuda_backend.lower_stateful_fused(prefix, suffix,
                                                     self.device, mit)
            if step is None:
                raise ValueError(
                    "backend='cuda' cannot serve this pipeline fused: "
                    + cuda_backend.fused_flow_decline_reason(prefix, suffix,
                                                             mit))
            self.flow_backend = self.classifier_backend = base
            self.mitigation_backend = base if mit is not None else None
        else:
            if backend == "cuda":
                flow = cuda_backend.lower_stateful(prefix, "cuda")
                self.flow_backend = base
                if cuda_backend.suffix_in_plain_walk(suffix):
                    classify = self._plain_suffix(suffix)
                    self.classifier_backend = "interpret"
                else:
                    classify = cuda_backend.lower_stages_cuda(
                        suffix, self.device, verdicts=True)
                    if classify is None:
                        raise ValueError(
                            "backend='cuda' cannot serve this suffix: "
                            + cuda_backend.stages_decline_reason(
                                suffix, verdicts=True))
                    self.classifier_backend = base
            else:
                flow = cuda_backend.lower_stateful(prefix, "interpret")
                classify = self._plain_suffix(suffix)
                self.flow_backend = self.classifier_backend = "interpret"

            def step(keys, regs, x, valid, _flow=flow, _cls=classify):
                k2, r2, feats = _flow(keys, regs, x, valid)
                return k2, r2, _cls(feats)

            self.mitigation_backend = None
            if mit is not None:
                # the action table appends two state tensors and the
                # verdict rewrite; the flow key is derived again from the
                # packet rows, so both tables stay keyed identically
                mit_fn, self.mitigation_backend = \
                    cuda_backend.lower_mitigation(mit)
                base_step = step

                def step(keys, regs, mkeys, mregs, x, valid, _base=base_step,
                         _mit=mit_fn, _fk=prefix[0]):
                    k2, r2, v = _base(keys, regs, x, valid)
                    mk2, mr2, v = _mit(mkeys, mregs, _fk.apply_keys(x), v,
                                       valid)
                    return k2, r2, mk2, mr2, v

        self.step_fn = step
        self._ones_valid: dict[int, torch.Tensor] = {}

    @staticmethod
    def _plain_suffix(suffix):
        return lambda feats, _s=tuple(suffix): stageir.apply_stages(
            _s, feats, plain=True)

    @property
    def n_state_arrays(self) -> int:
        """Leading state tensors of ``step_fn``: (keys, regs), plus
        (mit_keys, mit_regs) when mitigation is on."""
        return 2 + (2 if self.mitigation is not None else 0)

    @property
    def backend(self) -> str:
        """The engine that actually serves (see the module docstring)."""
        if self.fused:
            return f"{self.flow_backend}-fused-flow"
        kinds = {self.flow_backend, self.classifier_backend}
        if self.mitigation_backend is not None:
            kinds.add(self.mitigation_backend)
        return kinds.pop() if len(kinds) == 1 else "mixed"

    def with_backend(self, backend: str, device=None) -> "StatefulPipeline":
        """Recompile for another engine (and optionally device), keeping
        the ``fuse`` flag."""
        return StatefulPipeline(self.stages, backend=backend, fuse=self.fuse,
                                device=self.device if device is None
                                else device)

    def init_state(self):
        base = init_state(self.spec, self.device)
        if self.mitigation is None:
            return base
        mk, mr = init_mitigation(self.mitigation, self.device)
        return MitigatedFlowState(self.spec, base.keys, base.regs,
                                  self.mitigation, mk, mr)

    def _adopt_mitigation(self, state):
        old = getattr(state, "mit_spec", None)
        if old is None:                          # swapped in: start empty
            return init_mitigation(self.mitigation, self.device)
        if old == self.mitigation:
            return state.mit_keys, state.mit_regs
        return migrate_mitigation(state.mit_keys, state.mit_regs, old,
                                  self.mitigation)

    def adopt_state(self, state):
        """Carry another pipeline's live state into this pipeline's state
        shape (the hot-swap install path).  Detection table: the same spec
        keeps the tensors; a changed spec re-keys through
        ``registers.migrate_state``.  Action table: the same spec keeps
        the tensors (marked flows stay marked); a changed spec re-keys
        through ``mitigation.migrate_mitigation``; swapping mitigation in
        starts an empty table, swapping it out drops the table."""
        if state.keys.device != self.device:
            raise ValueError(f"state lives on {state.keys.device}, "
                             f"pipeline on {self.device}")
        if state.spec == self.spec:
            keys, regs = state.keys, state.regs
        else:
            m = migrate_state(FlowState(state.spec, state.keys, state.regs),
                              self.spec)
            keys, regs = m.keys, m.regs
        if self.mitigation is None:
            return FlowState(self.spec, keys, regs)
        mk, mr = self._adopt_mitigation(state)
        return MitigatedFlowState(self.spec, keys, regs, self.mitigation,
                                  mk, mr)

    def _state_arrays(self, state) -> list:
        if state.keys.device != self.device:
            raise ValueError(f"state lives on {state.keys.device}, "
                             f"pipeline on {self.device}")
        if self.mitigation is None:
            return [state.keys, state.regs]
        if getattr(state, "mit_spec", None) != self.mitigation:
            raise ValueError("a mitigated pipeline needs a "
                             "MitigatedFlowState with its MitigationSpec")
        return [state.keys, state.regs, state.mit_keys, state.mit_regs]

    def _wrap_state(self, outs):
        if self.mitigation is None:
            return FlowState(self.spec, outs[0], outs[1]), outs[-1]
        return (MitigatedFlowState(self.spec, outs[0], outs[1],
                                   self.mitigation, outs[2], outs[3]),
                outs[-1])

    def dispatch(self, state, X, valid=None):
        """Launch one step without waiting for the result -> (state',
        verdicts as a device tensor).  Successive dispatches chain through
        the returned state on one stream, so batches apply in order."""
        arrays = self._state_arrays(state)
        X = torch.as_tensor(X, dtype=torch.float32).to(self.device,
                                                       non_blocking=True)
        B = int(X.shape[0])
        if valid is None:
            valid = self._ones_valid.get(B)
            if valid is None:
                valid = self._ones_valid.setdefault(
                    B, torch.ones(B, dtype=torch.int32, device=self.device))
        valid = torch.as_tensor(valid, dtype=torch.int32).to(
            self.device, non_blocking=True)
        return self._wrap_state(self.step_fn(*arrays, X, valid))

    def __call__(self, state, X, valid=None):
        state, verdicts = self.dispatch(state, X, valid)
        return state, verdicts.cpu().numpy().astype(np.int32)

    def __repr__(self):
        mit = (f", mitigation={self.mitigation.mode!r}"
               if self.mitigation is not None else "")
        return (f"StatefulPipeline(slots={self.spec.n_slots}, "
                f"width={self.spec.width}, backend={self.backend!r}{mit}, "
                f"device={str(self.device)!r})")
