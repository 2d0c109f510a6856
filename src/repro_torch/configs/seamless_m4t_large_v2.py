"""SeamlessM4T-large v2. [arXiv:2308.11596]

Encoder-decoder, multimodal speech/text.  The mel-spectrogram + conformer conv
feature extractor is the stubbed frontend (per the carve-out): input_specs()
provides precomputed frame embeddings of shape (B, S, 1024) which the 24-layer
transformer encoder consumes; the 24-layer decoder cross-attends to the
encoder memory.  vocab 256206 (NLLB unit+text vocabulary).
Decode shapes run against a precomputed encoder memory; long_500k skipped
(enc-dec full attention).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        citation="arXiv:2308.11596",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        enc_layers=24,
        enc_d_model=1024,
        cross_attn=True,
        audio_frontend=True,
        mlp_act="silu",
        mlp_gated=True,
        supports_long_context=False,
    )
)
