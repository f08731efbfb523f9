"""Stateful serving pipeline (counterpart of
``repro.flowstate.pipeline.StatefulPipeline``): one register file, or in
the multi-table form several ``FlowKey RegisterUpdate [WindowStats]``
groups feeding one classifier, with an optional trailing ``Mitigate``
action table.

Per fixed-shape batch it derives flow keys, updates the register
file(s), reads each packet's post-update row(s) and classifies them
(several tables' readouts concatenated in group order); a ``Mitigate``
stage then feeds the verdicts to the action table, keyed by the first
table's flow key, and dropped packets come back as ``MITIGATED``.  The
state — (keys, regs) per table, plus (mit_keys, mit_regs) when mitigated
— threads through as explicit tensors: a ``FlowState``,
``MitigatedFlowState`` or, for several tables, ``MultiFlowState``.  On the
card it is donated, as the JAX package donates it on accelerators: the
kernels update the given state's tensors in place, so a dispatched-into
state is consumed and callers adopt the returned one (the engine always
does).  On the CPU and under ``"interpret"`` the given state is never
written.

Backends, reported by ``backend`` as what actually serves:

  ``backend="cuda", fuse=True``   the single K1 launch per batch (every
                                  table, the classifier and the action
                                  table; ``"cuda-fused-flow"``);
  ``backend="cuda", fuse=False``  K2 per table, then K3 (MLP) or
                                  K4 (MAT) for the classifier
                                  (``"cuda"``).  Where the JAX package
                                  has no kernel either — the action table,
                                  a centroid classifier and the readout of
                                  a features-only pipeline on the split
                                  path — the part runs its plain version
                                  on the pipeline's device (the action
                                  table as whole-batch tensor operations
                                  with no host sync), reported
                                  ``"interpret"``, and the whole
                                  ``"mixed"``, as the JAX package reports
                                  it;
  ``fuse=True`` is the default and the faster kernel at every MLP width
  measured: K1 walks the slot chains, then classifies each packet's row
  on a warp of its own, so even the design space's deepest classifier
  (weights read through L2) costs K1 less than K2 + K3 per batch
  (PERF.md, the kernel table's row 1e);
  ``backend="interpret"``         the plain stage walk: sequential
                                  register update + each stage's plain
                                  ``apply`` + the plain action-table walk
                                  (``"interpret"``).

On ``device="cpu"`` the cuda lowerings run the same ops, which take their
plain versions for CPU tensors; they report ``"cpu-ref-fused-flow"`` and
``"cpu-ref"`` (or ``"mixed"``).  ``backend="cuda"`` never walks a part
the JAX package has a kernel for: it raises with the reason
(``fallback_reason`` is therefore always None in the port).
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
    MultiFlowState,
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
            groups, suffix = stageir.split_stateful_multi(rest)
            fused_prefix = groups
        else:
            prefix, suffix = stageir.split_stateful(rest)
            groups = [(prefix[0], prefix[1], None)]
            fused_prefix = prefix
        self.groups = groups
        self.n_tables = len(groups)
        self.specs = tuple(g[1].spec for g in groups)
        self.spec = self.specs[0]
        self.mitigation = mit.spec if mit is not None else None
        self.fallback_reason: str | None = None
        self.fused = backend == "cuda" and self.fuse
        base = stageir.kernel_backend(self.device)

        if self.fused:
            step = cuda_backend.lower_stateful_fused(fused_prefix, suffix,
                                                     self.device, mit)
            if step is None:
                raise ValueError(
                    "backend='cuda' cannot serve this pipeline fused: "
                    + cuda_backend.fused_flow_decline_reason(
                        fused_prefix, suffix, mit))
            self.flow_backend = self.classifier_backend = base
            self.mitigation_backend = base if mit is not None else None
        else:
            flows = tuple(cuda_backend.lower_stateful(
                [fk, ru], "cuda" if backend == "cuda" else "interpret")
                for fk, ru, _ in groups)
            if backend == "cuda":
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
                classify = self._plain_suffix(suffix)
                self.flow_backend = self.classifier_backend = "interpret"
            readouts = tuple(g[2] for g in groups)
            n = self.n_tables

            def step(*args, _flows=flows, _ws=readouts, _cls=classify):
                x, valid = args[-2], args[-1]
                outs, zs = [], []
                for t, flow in enumerate(_flows):
                    k2, r2, feats = flow(args[2 * t], args[2 * t + 1], x,
                                         valid)
                    outs += [k2, r2]
                    zs.append(feats if _ws[t] is None
                              else _ws[t].apply(feats))
                z = zs[0] if len(zs) == 1 else torch.cat(zs, 1)
                return (*outs, _cls(z))

            self.mitigation_backend = None
            if mit is not None:
                # the action table appends two state tensors and the
                # verdict rewrite; the first table's flow key is derived
                # again from the packet rows, so both tables stay keyed
                # identically
                mit_fn, self.mitigation_backend = \
                    cuda_backend.lower_mitigation(mit)
                base_step = step

                def step(*args, _base=base_step, _mit=mit_fn,
                         _fk=groups[0][0]):
                    x, valid = args[-2], args[-1]
                    out = _base(*args[:2 * n], x, valid)
                    mk2, mr2, v = _mit(args[2 * n], args[2 * n + 1],
                                       _fk.apply_keys(x), out[-1], valid)
                    return (*out[:-1], mk2, mr2, v)

        self.step_fn = step
        self._ones_valid: dict[int, torch.Tensor] = {}

    @staticmethod
    def _plain_suffix(suffix):
        return lambda feats, _s=tuple(suffix): stageir.apply_stages(
            _s, feats, plain=True)

    @property
    def n_state_arrays(self) -> int:
        """Leading state tensors of ``step_fn``: (keys, regs) per table,
        plus (mit_keys, mit_regs) when mitigation is on."""
        return 2 * self.n_tables + (2 if self.mitigation is not None else 0)

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

    def _with_mitigation(self, kl, rl, mit):
        """Tables (+ the action table ``mit``) -> this pipeline's state."""
        if self.n_tables > 1:
            if mit is None:
                return MultiFlowState(self.specs, tuple(kl), tuple(rl))
            return MultiFlowState(self.specs, tuple(kl), tuple(rl),
                                  self.mitigation, *mit)
        if mit is None:
            return FlowState(self.spec, kl[0], rl[0])
        return MitigatedFlowState(self.spec, kl[0], rl[0], self.mitigation,
                                  *mit)

    def init_state(self):
        bases = [init_state(s, self.device) for s in self.specs]
        mit = (None if self.mitigation is None
               else init_mitigation(self.mitigation, self.device))
        return self._with_mitigation([b.keys for b in bases],
                                     [b.regs for b in bases], mit)

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
        shape (the hot-swap install path).  Detection tables: with the
        same table count, a table of the same spec keeps its tensors and
        a changed spec re-keys through ``registers.migrate_state``; a
        change of the table count (single to multi-table included) starts
        the detection tables fresh, since no table corresponds to
        another.  Action table, in every case: the same spec keeps the
        tensors (marked flows stay marked); a changed spec re-keys through
        ``mitigation.migrate_mitigation``; swapping mitigation in starts
        an empty table, swapping it out drops the table."""
        if state.keys.device != self.device:
            raise ValueError(f"state lives on {state.keys.device}, "
                             f"pipeline on {self.device}")
        old_specs = getattr(state, "specs", (state.spec,))
        if len(old_specs) == self.n_tables:
            old_keys = getattr(state, "keys_list", (state.keys,))
            old_regs = getattr(state, "regs_list", (state.regs,))
            kl, rl = [], []
            for old, spec, k, r in zip(old_specs, self.specs, old_keys,
                                       old_regs):
                if old != spec:
                    m = migrate_state(FlowState(old, k, r), spec)
                    k, r = m.keys, m.regs
                kl.append(k)
                rl.append(r)
        else:                                    # table count changed
            bases = [init_state(s, self.device) for s in self.specs]
            kl, rl = [b.keys for b in bases], [b.regs for b in bases]
        mit = (None if self.mitigation is None
               else self._adopt_mitigation(state))
        return self._with_mitigation(kl, rl, mit)

    def _state_arrays(self, state) -> list:
        if state.keys.device != self.device:
            raise ValueError(f"state lives on {state.keys.device}, "
                             f"pipeline on {self.device}")
        if self.n_tables > 1:
            if tuple(getattr(state, "specs", ())) != self.specs:
                raise ValueError("a multi-table pipeline needs a "
                                 "MultiFlowState with its specs")
            arrays = [a for kr in zip(state.keys_list, state.regs_list)
                      for a in kr]
        else:
            arrays = [state.keys, state.regs]
        if self.mitigation is None:
            return arrays
        if getattr(state, "mit_spec", None) != self.mitigation:
            raise ValueError("a mitigated pipeline needs a "
                             "MitigatedFlowState (a MultiFlowState for "
                             "several tables) with its MitigationSpec")
        return arrays + [state.mit_keys, state.mit_regs]

    def _wrap_state(self, outs):
        nt = self.n_tables
        mit = None if self.mitigation is None else outs[2 * nt:2 * nt + 2]
        return (self._with_mitigation(outs[0:2 * nt:2], outs[1:2 * nt:2],
                                      mit), outs[-1])

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
        tabs = f", tables={self.n_tables}" if self.n_tables > 1 else ""
        return (f"StatefulPipeline(slots={self.spec.n_slots}, "
                f"width={self.spec.width}, backend={self.backend!r}{mit}"
                f"{tabs}, device={str(self.device)!r})")
