from repro_torch.kernels.selective_scan.ops import (
    STATE_WIDTHS,
    selective_scan,
    selective_scan_launch,
)
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
