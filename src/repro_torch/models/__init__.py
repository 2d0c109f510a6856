from repro_torch.models.transformer import (
    cache_specs,
    decode_step,
    init_params,
    model_dtype,
    period_info,
    prefill,
    require_supported,
)
