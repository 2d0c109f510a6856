"""Model configs + architecture registry (the port's copy).

A copy of ``repro/configs/base.py``'s model half: ``ModelConfig`` with
``layer_kinds``, ``padded_vocab`` and ``reduced()``, the
MoE/Mamba sub-configs its fields name, and ``register``/``get_config``.
``SyncConfig``/``TrainConfig`` belong to the training slice and are not here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

ATTN_GLOBAL = "attn"          # full causal attention
ATTN_SWA = "attn_swa"         # sliding-window attention
ATTN_CHUNK = "attn_chunk"     # chunked-local attention (llama4 iRoPE local)
MAMBA = "mamba"               # Mamba2 SSD block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    citation: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0
    attn_chunk: int = 0
    layer_pattern: Optional[Sequence[str]] = None
    mlp_act: str = "silu"
    mlp_gated: bool = True
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    mamba: Optional[MambaConfig] = None
    enc_layers: int = 0
    enc_d_model: int = 0
    cross_attn: bool = False
    vision_tokens: int = 0
    audio_frontend: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    supports_long_context: bool = False

    def padded_vocab(self, multiple: int = 16) -> int:
        """Vocab rounded up to ``multiple`` (the logits' padded rows)."""
        return -(-self.vocab_size // multiple) * multiple

    def layer_kinds(self) -> tuple:
        if self.layer_pattern is None:
            kind = ATTN_GLOBAL
            if self.sliding_window > 0:
                kind = ATTN_SWA
            elif self.attn_chunk > 0:
                kind = ATTN_CHUNK
            return (kind,) * self.num_layers
        pat = tuple(self.layer_pattern)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/topology, tiny dims (the same
        rule as the JAX package, so both reduce a config identically)."""
        d = min(self.d_model, 128)
        hd = 32
        nh = max(2, min(4, self.num_heads)) if self.num_heads else 0
        nkv = max(1, min(nh or 1, max(1, self.num_kv_heads * nh // max(1, self.num_heads))))
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=4, top_k=min(self.moe.top_k, 2))
        mamba = None
        if self.mamba is not None:
            mamba = replace(self.mamba, d_state=16, head_dim=16, chunk_size=8)
        pat = None
        if self.layer_pattern is not None:
            pat = tuple(self.layer_pattern)[:2] if len(self.layer_pattern) >= 2 else self.layer_pattern
        return replace(
            self,
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) or 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            attn_chunk=min(self.attn_chunk, 16) if self.attn_chunk else 0,
            layer_pattern=pat,
            moe=moe,
            mamba=mamba,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_d_model=min(self.enc_d_model, d) if self.enc_d_model else 0,
            vision_tokens=min(self.vision_tokens, 4) if self.vision_tokens else 0,
            dtype="float32",
        )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import h2o_danube_1_8b  # noqa: F401  (registers)

