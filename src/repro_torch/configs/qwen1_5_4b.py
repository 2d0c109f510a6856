"""Qwen1.5-4B. [hf:Qwen/Qwen1.5-0.5B family card, 4B variant]

Dense decoder with QKV bias; GQA kv=20 (i.e. MHA at this scale: 20 q heads,
20 kv heads).  Full causal attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        citation="hf:Qwen/Qwen1.5-0.5B",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        mlp_act="silu",
        mlp_gated=True,
        supports_long_context=False,
    )
)
