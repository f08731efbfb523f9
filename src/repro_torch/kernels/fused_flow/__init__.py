from repro_torch.kernels.fused_flow.ops import (
    fused_flow_serve,
    fused_flow_serve_launch,
)
from repro_torch.kernels.fused_flow.ref import (
    READOUT_MODES,
    SuffixPlan,
    TablePlan,
    fused_flow_serve_ref,
    suffix_readout,
    suffix_verdicts,
)
