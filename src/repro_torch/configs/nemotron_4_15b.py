"""Nemotron-4-15B. [arXiv:2402.16819]

Dense decoder with squared-ReLU MLP (non-gated), GQA kv=8, 256000 vocab
(SentencePiece multilingual), rotary position embeddings.
Full causal attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        citation="arXiv:2402.16819",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        mlp_act="relu2",
        mlp_gated=False,
        supports_long_context=False,
    )
)
