from repro_torch.sharding.rules import (
    param_specs,
    opt_state_specs,
    batch_specs,
    cache_pspecs,
    maybe_axis,
    DATA_AXES,
    placements,
)
