"""Per-flow register file, the mitigation action table, the stateful
serving pipeline and the drift detector of the online loop."""

from repro_torch.flowstate.drift import DriftDetector, DriftSnapshot

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
    update_flows,
)
