from repro_torch.kernels.selective_scan.ops import (
    STATE_WIDTHS,
    selective_scan,
    selective_scan_discretized,
    selective_scan_discretized_launch,
    selective_scan_launch,
)
from repro_torch.kernels.selective_scan.ref import (
    discretize,
    selective_scan_channel_ref,
    selective_scan_discretized_ref,
    selective_scan_ref,
)
