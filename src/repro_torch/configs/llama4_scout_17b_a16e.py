"""Llama-4 Scout 17B-active / 16 experts.

[hf:meta-llama/Llama-4-Scout-17B-16E]  MoE (16 experts, top-1 routing, one
shared expert), early-fusion multimodal (vision patch embeddings projected into
the token stream -> frontend stubbed per the carve-out), iRoPE attention:
3 chunked-local (RoPE) layers : 1 global (NoPE) layer.  The chunked-local
attention makes decode memory sub-quadratic in context, so long_500k runs.
"""
from repro_torch.configs.base import ATTN_CHUNK, ATTN_GLOBAL, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        attn_chunk=8192,
        layer_pattern=(ATTN_CHUNK, ATTN_CHUNK, ATTN_CHUNK, ATTN_GLOBAL),
        mlp_act="silu",
        mlp_gated=True,
        moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True),
        vision_tokens=256,
        rope_theta=500000.0,
        supports_long_context=True,
    )
)
