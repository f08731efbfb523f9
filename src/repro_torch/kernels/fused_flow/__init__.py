from repro_torch.kernels.fused_flow.ops import (
    MAX_TABLES,
    centroid_envelope_reason,
    fused_flow_serve,
    fused_flow_serve_launch,
    fused_flow_serve_multi,
    fused_flow_serve_multi_launch,
    mitigation_segments,
    tables_reason,
)
from repro_torch.kernels.fused_flow.mitigate_ref import (
    MITIGATED,
    MitigationSpec,
    mitigate_update,
    mitigate_update_segmented,
    mitigate_update_staged,
)
from repro_torch.kernels.fused_flow.ref import (
    READOUT_MODES,
    SUFFIX_KINDS,
    Centroids,
    SuffixPlan,
    TablePlan,
    centroid_scores_ref,
    fused_flow_serve_multi_ref,
    fused_flow_serve_ref,
    pack_centroids,
    suffix_readout,
    suffix_scores,
    suffix_verdicts,
)
