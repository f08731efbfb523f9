"""Per-flow register file, the mitigation action table and the stateful
serving pipeline."""

from repro_torch.flowstate.mitigation import (
    MITIGATED,
    MitigatedFlowState,
    MitigationSpec,
    init_mitigation,
    migrate_mitigation,
    mitigate_update,
    mitigate_update_segmented,
)
from repro_torch.flowstate.pipeline import StatefulPipeline
from repro_torch.flowstate.registers import (
    FlowState,
    FlowStateSpec,
    MultiFlowState,
    hash_slot_np,
    init_state,
    migrate_state,
)
