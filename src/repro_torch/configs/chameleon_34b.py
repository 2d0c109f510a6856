"""Chameleon-34B. [arXiv:2405.09818]

Early-fusion mixed-modal: images are VQ-tokenized into the same 65536-entry
vocabulary, so the backbone consumes one interleaved token stream (the VQ-GAN
tokenizer is the stubbed frontend).  Uses QK-norm for training stability.
Full causal attention -> long_500k skipped (quadratic decode memory).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        citation="arXiv:2405.09818",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
        mlp_act="silu",
        mlp_gated=True,
        supports_long_context=False,
    )
)
