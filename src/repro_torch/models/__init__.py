from repro_torch.models.transformer import (
    cache_specs,
    decode_step,
    encode,
    forward_train,
    init_params,
    loss_fn,
    model_dtype,
    period_info,
    prefill,
)
