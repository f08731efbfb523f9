"""Per-flow register file and the stateful serving pipeline."""

from repro_torch.flowstate.pipeline import StatefulPipeline
from repro_torch.flowstate.registers import (
    FlowState,
    FlowStateSpec,
    hash_slot_np,
    init_state,
)
