"""Jamba-1.5-Large (398B total). [arXiv:2403.19887]

Hybrid Mamba+attention at a 7:1 mamba:attention interleave, MoE (16 experts,
top-2) applied every second layer.  The constant-size SSD state plus sparse
attention layers keep decode memory manageable -> long_500k runs (the 9
attention layers keep full KV, the 63 mamba layers keep O(1) state).
"""
from repro_torch.configs.base import ATTN_GLOBAL, MAMBA, MambaConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        citation="arXiv:2403.19887",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        # period-8 block: attention at position 4, mamba elsewhere (1:7)
        layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN_GLOBAL, MAMBA, MAMBA, MAMBA),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk_size=256),
        mlp_act="silu",
        mlp_gated=True,
        moe=MoEConfig(num_experts=16, top_k=2),
        moe_every=2,
        supports_long_context=True,
    )
)
