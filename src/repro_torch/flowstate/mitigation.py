"""In-pipeline mitigation: the per-flow drop / rate-limit action table
(counterpart of ``repro.flowstate.mitigation``).

A second, small register file (the action table) keyed by the same flow
key as the detection table and fed by the classifier's verdicts.  Once a
flow has ``threshold`` verdicts of ``attack_class`` its slot is marked:
every later packet of the flow is dropped (``mode="drop"``) or, under
``mode="rate_limit"``, every ``keep_every``-th packet passes and keeps
being classified while the rest are dropped.  A dropped packet's verdict
becomes ``MITIGATED`` (-1).  The state BEFORE a packet decides its fate,
so the packet that trips the threshold is itself verdicted and no packet
is both dropped and verdicted.

The policy (``MitigationSpec``) and the update's plain versions live
beside the kernel that folds the table in
(``kernels.fused_flow.mitigate_ref``) and are re-exported here; this
module adds the state that threads through a pipeline and the hot-swap
re-keying.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.flowstate.registers import FlowStateSpec, hash_slot_np
from repro_torch.kernels.fused_flow.mitigate_ref import (  # noqa: F401
    MIT_WIDTH,
    MITIGATED,
    MitigationSpec,
    mitigate_update,
    mitigate_update_segmented,
)


def init_mitigation(spec: MitigationSpec, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty action table -> (mit_keys [Sm] int32, mit_regs [Sm, 2] f32)."""
    dev = resolve_device(device)
    return (torch.full((spec.n_slots,), -1, dtype=torch.int32, device=dev),
            torch.zeros((spec.n_slots, MIT_WIDTH), dtype=torch.float32,
                        device=dev))


@dataclasses.dataclass
class MitigatedFlowState:
    """Detection register file + action table, threaded as one state.
    The flow fields keep ``FlowState``'s names (``spec``/``keys``/
    ``regs``), so code that reads the detection table works unchanged."""

    spec: FlowStateSpec
    keys: torch.Tensor         # [S] int32 detection keys
    regs: torch.Tensor         # [S, W] f32 detection rows
    mit_spec: MitigationSpec
    mit_keys: torch.Tensor     # [Sm] int32 action keys, -1 = empty
    mit_regs: torch.Tensor     # [Sm, 2] f32 [hits, since]

    @property
    def occupied(self) -> int:
        return int((self.keys >= 0).sum())

    @property
    def mitigated_flows(self) -> int:
        """Action slots currently marked (hits >= threshold)."""
        marked = (self.mit_keys >= 0) \
            & (self.mit_regs[:, 0] >= self.mit_spec.threshold)
        return int(marked.sum())


def migrate_mitigation(mit_keys: torch.Tensor, mit_regs: torch.Tensor,
                       old_spec: MitigationSpec, new_spec: MitigationSpec):
    """Re-key the action table for a hot swap that changes the mitigation
    spec: occupied rows re-hash into the new table in ascending slot
    order and collisions resolve last-writer-wins, as in
    ``registers.migrate_state``.  Rows carry verbatim (the layout does not
    depend on the spec); a changed threshold or mode reinterprets them
    from the next packet on.  -> tensors on the input's device."""
    del old_spec                  # only n_slots re-keys
    dev = mit_keys.device
    keys = mit_keys.cpu().numpy()
    regs = mit_regs.cpu().numpy()
    out_k = np.full((new_spec.n_slots,), -1, np.int32)
    out_r = np.zeros((new_spec.n_slots, MIT_WIDTH), np.float32)
    occupied = np.flatnonzero(keys >= 0)       # ascending slot order
    for i, s in zip(occupied, hash_slot_np(keys[occupied],
                                           new_spec.n_slots)):
        out_k[s] = keys[i]
        out_r[s] = regs[i]
    return (torch.as_tensor(out_k, device=dev),
            torch.as_tensor(out_r, device=dev))
