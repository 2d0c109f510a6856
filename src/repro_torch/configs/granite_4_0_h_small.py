"""Granite-4.0-H-Small (32B total, 9B active).
[hf:ibm-granite/granite-4.0-h-small, config.json]

A hybrid of Mamba2 and attention at a period of 10 (nine Mamba2 mixers,
then a GQA attention layer at position 5), every layer's MLP a dropless
mixture of 72 SwiGLU experts of width 768 (top 10, a softmax over the
chosen logits) beside a shared SwiGLU expert of width 1536.  The attention
layers have no positional encoding and a softmax scale of 1/128; the
embedding's output is scaled by 12, every residual branch by 0.22, and the
logits divided by 16; a tied vocabulary of 100,352.  The port's own
architecture: the JAX package has none like it.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MAMBA, MambaConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        citation="hf:ibm-granite/granite-4.0-h-small",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=768,
        vocab_size=100352,
        layer_pattern=(MAMBA,) * 5 + (ATTN_GLOBAL,) + (MAMBA,) * 4,
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                          chunk_size=256),
        mlp_act="silu",
        mlp_gated=True,
        moe=MoEConfig(num_experts=72, top_k=10, shared_expert=True, shared_d_ff=1536,
                      dropless=True),
        tie_embeddings=True,
        norm_eps=1e-5,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        attn_scale=0.0078125,
        nope=True,
        supports_long_context=True,
    )
)
