from repro_torch.kernels.flow_update.ops import (
    MAX_HISTS,
    MAX_SLOTS,
    MAX_WIDTH,
    Segments,
    flow_update,
    flow_update_launch,
    segment_batch,
)
from repro_torch.kernels.flow_update.ref import (
    ewma_blend,
    flow_update_ref,
    flow_update_staged_ref,
    hash_slot,
)
