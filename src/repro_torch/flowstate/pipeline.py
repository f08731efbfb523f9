"""Stateful serving pipeline (counterpart of
``repro.flowstate.pipeline.StatefulPipeline``), single table, no
mitigation.

Per fixed-shape batch it derives flow keys, updates the register file,
reads each packet's post-update row and classifies it.  The register
state threads through as explicit tensors.  On the card the state is
donated, as the JAX package donates it on accelerators: the kernels
update the given ``FlowState``'s tensors in place, so a dispatched-into
state is consumed and callers adopt the returned one (the engine always
does).  On the CPU and under ``"interpret"`` the given state is never
written.

Backends, reported by ``backend`` as what actually serves:

  ``backend="cuda", fuse=True``   the single K1 launch per batch
                                  (``"cuda-fused-flow"``);
  ``backend="cuda", fuse=False``  K2 for the registers, then K3 for the
                                  classifier (``"cuda"``);
  ``backend="interpret"``         the plain stage walk: sequential
                                  register update + each stage's plain
                                  ``apply`` (``"interpret"``).

On ``device="cpu"`` the cuda lowerings run the same ops, which take their
plain versions for CPU tensors; they report ``"cpu-ref-fused-flow"`` and
``"cpu-ref"``.  ``backend="cuda"`` never walks a pipeline it cannot
lower: it raises with the reason (``fallback_reason`` is therefore always
None in the port).  A ``Mitigate`` stage or a second ``FlowKey`` raises
``NotImplementedError``: those are later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cuda_backend, stageir
from repro_torch.device import resolve_device
from repro_torch.flowstate.registers import FlowState, init_state

EXEC_BACKENDS = ("interpret", "cuda")
REPORT_BACKENDS = ("interpret", "cuda", "cuda-fused-flow", "cpu-ref",
                   "cpu-ref-fused-flow")


class StatefulPipeline:
    """``state', verdicts = pipe(state, X, valid=None)`` for a [B, F]
    packet batch; ``valid`` masks ragged-batch padding rows, which never
    touch the register file (their verdicts are meaningless)."""

    def __init__(self, stages, *, backend: str = "interpret",
                 fuse: bool = True, device="cuda"):
        if backend not in EXEC_BACKENDS:
            raise KeyError(f"backend must be one of {EXEC_BACKENDS}")
        self.device = resolve_device(device)
        self.stages = list(stages)
        self.requested_backend = backend
        self.fuse = bool(fuse)
        rest, mit = stageir.split_mitigation(self.stages)
        if mit is not None:
            raise NotImplementedError(
                "Mitigate (the per-flow action table) is not yet ported; it "
                "comes with the mitigation slice of the fused kernel")
        if sum(isinstance(s, stageir.FlowKey) for s in rest) > 1:
            raise NotImplementedError(
                "multi-table pipelines (several FlowKey/RegisterUpdate "
                "groups) are not yet ported; they come in a later slice")
        prefix, suffix = stageir.split_stateful(rest)
        self.spec = prefix[1].spec
        self.fallback_reason: str | None = None
        self.fused = backend == "cuda" and self.fuse

        if self.fused:
            step = cuda_backend.lower_stateful_fused(prefix, suffix,
                                                     self.device)
            if step is None:
                raise ValueError(
                    "backend='cuda' cannot serve this pipeline fused: "
                    + cuda_backend.fused_flow_decline_reason(prefix, suffix))
        elif backend == "cuda":
            flow = cuda_backend.lower_stateful(prefix, "cuda")
            classify = cuda_backend.lower_stages_cuda(suffix, self.device)
            if classify is None:
                raise ValueError(
                    "backend='cuda' cannot serve this suffix: "
                    + cuda_backend.stages_decline_reason(suffix))

            def step(keys, regs, x, valid, _flow=flow, _cls=classify):
                k2, r2, feats = _flow(keys, regs, x, valid)
                return k2, r2, _cls(feats)
        else:
            flow = cuda_backend.lower_stateful(prefix, "interpret")
            plain = stageir.unfuse_pipeline_stages(suffix)

            def step(keys, regs, x, valid, _flow=flow, _s=tuple(plain)):
                k2, r2, feats = _flow(keys, regs, x, valid)
                return k2, r2, stageir.apply_stages(_s, feats)

        self.step_fn = step
        self._ones_valid: dict[int, torch.Tensor] = {}

    @property
    def n_state_arrays(self) -> int:
        """Leading state tensors of ``step_fn``: (keys, regs)."""
        return 2

    @property
    def backend(self) -> str:
        """The engine that actually serves (see the module docstring)."""
        if self.requested_backend == "interpret":
            return "interpret"
        base = "cuda" if self.device.type == "cuda" else "cpu-ref"
        return f"{base}-fused-flow" if self.fused else base

    def with_backend(self, backend: str, device=None) -> "StatefulPipeline":
        """Recompile for another engine (and optionally device), keeping
        the ``fuse`` flag."""
        return StatefulPipeline(self.stages, backend=backend, fuse=self.fuse,
                                device=self.device if device is None
                                else device)

    def init_state(self) -> FlowState:
        return init_state(self.spec, self.device)

    def dispatch(self, state: FlowState, X, valid=None):
        """Launch one step without waiting for the result -> (state',
        verdicts as a device tensor).  Successive dispatches chain through
        the returned state on one stream, so batches apply in order."""
        if state.keys.device != self.device:
            raise ValueError(f"state lives on {state.keys.device}, "
                             f"pipeline on {self.device}")
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
        keys, regs, verdicts = self.step_fn(state.keys, state.regs, X, valid)
        return FlowState(self.spec, keys, regs), verdicts

    def __call__(self, state: FlowState, X, valid=None):
        state, verdicts = self.dispatch(state, X, valid)
        return state, verdicts.cpu().numpy().astype(np.int32)

    def __repr__(self):
        return (f"StatefulPipeline(slots={self.spec.n_slots}, "
                f"width={self.spec.width}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")
