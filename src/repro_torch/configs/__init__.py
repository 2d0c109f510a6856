from repro_torch.configs.base import (
    ATTN_CHUNK,
    ATTN_GLOBAL,
    ATTN_SWA,
    MAMBA,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    get_config,
    list_configs,
    register,
)
