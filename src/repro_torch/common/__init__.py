from repro_torch.common.pytree import (
    cast_floating,
    param_bytes,
    param_count,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_path_str,
    tree_paths,
)
