"""Mamba2-2.7B. [arXiv:2405.21060]

Attention-free state-space model using the SSD (state-space duality) block:
chunked matmul formulation for training, O(1)-state recurrent step for decode.
d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads, d_state 128.
No MLP (d_ff=0): the SSD block is the whole layer, as in the paper.
long_500k runs (constant-size recurrent state).
"""
from repro_torch.configs.base import MAMBA, MambaConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        citation="arXiv:2405.21060",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        layer_pattern=(MAMBA,),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
        tie_embeddings=True,
        supports_long_context=True,
    )
)
