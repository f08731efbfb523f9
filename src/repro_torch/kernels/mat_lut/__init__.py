from repro_torch.kernels.mat_lut.ops import (
    MAX_BINS,
    MAX_CLASSES,
    MAX_FEATURES,
    MAX_TABLE_BYTES,
    MatTables,
    mat_classify,
    mat_classify_launch,
    mat_envelope_reason,
    pack_mat,
)
from repro_torch.kernels.mat_lut.ref import (
    arg_reduce,
    mat_buckets,
    mat_classify_ref,
    mat_classify_split_ref,
    mat_scores_ref,
)
