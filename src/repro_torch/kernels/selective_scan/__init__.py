from repro_torch.kernels.selective_scan.ops import (
    STATE_WIDTHS,
    SelectiveScanFn,
    selective_scan,
    selective_scan_bwd_launch,
    selective_scan_discretized,
    selective_scan_discretized_launch,
    selective_scan_launch,
)
from repro_torch.kernels.selective_scan.ref import (
    bwd_channels,
    bwd_chunk,
    discretize,
    scan_checkpoints,
    selective_scan_bwd_chunked_ref,
    selective_scan_bwd_ref,
    selective_scan_channel_ref,
    selective_scan_discretized_ref,
    selective_scan_ref,
)
