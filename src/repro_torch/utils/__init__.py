from repro_torch.utils.device import fold_seed, make_generator, resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (TreeDef, tree_flatten,
                                    tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_unflatten)
