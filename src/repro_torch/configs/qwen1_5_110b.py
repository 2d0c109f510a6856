"""Qwen1.5-110B. [hf:Qwen/Qwen1.5-0.5B family card, scaled 110B variant]

Dense llama-style decoder with QKV bias (the Qwen1.5 signature), GQA kv=8.
Full causal attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        citation="hf:Qwen/Qwen1.5-0.5B",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        mlp_act="silu",
        mlp_gated=True,
        supports_long_context=False,
    )
)
