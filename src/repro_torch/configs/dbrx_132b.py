"""DBRX-132B. [hf:databricks/dbrx-base]

Fine-grained MoE: 16 experts, top-4 routing (more, smaller experts than
Mixtral-style designs), GQA kv=8.  Full causal attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        citation="hf:databricks/dbrx-base",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        mlp_act="silu",
        mlp_gated=True,
        moe=MoEConfig(num_experts=16, top_k=4),
        rope_theta=500000.0,
        supports_long_context=False,
    )
)
