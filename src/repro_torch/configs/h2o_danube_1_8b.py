"""H2O-Danube-1.8B. [arXiv:2401.16818]

Llama+Mistral architecture mix: llama-style blocks with Mistral's
sliding-window attention (window 4096), GQA kv=8, vocab 32000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        citation="arXiv:2401.16818",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,
        mlp_act="silu",
        mlp_gated=True,
        supports_long_context=True,
    )
)
