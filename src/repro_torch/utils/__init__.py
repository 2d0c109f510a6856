from repro_torch.utils.device import fold_seed, make_generator, resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (TreeDef, global_norm, tree_add, tree_bytes, tree_dot,
                                    tree_flatten, tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_norm, tree_scale, tree_size, tree_sub,
                                    tree_unflatten, tree_zeros_like)
