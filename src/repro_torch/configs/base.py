"""Model configs + architecture registry (the port's copy).

A copy of ``repro/configs/base.py``: ``ModelConfig`` with
``layer_kinds``, ``padded_vocab``, ``param_count``, ``active_param_count``
and ``reduced()``, the MoE/Mamba sub-configs its fields name, the training
knobs ``LevelConfig``/``SyncConfig``/``TrainConfig`` (same fields, same
defaults), the dry-run's ``InputShape`` table ``INPUT_SHAPES``, and
``register``/``get_config``.  Beyond the copy: the fields granite-4.0-h
needs (the multipliers, the softmax scale, NoPE; the shared expert's
width, the experts one rank holds, dropless routing), each a no-op at its
default, and its registration, an architecture the JAX package lacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

from repro_torch.faults.model import FaultConfig

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
    # the port's own fields (the JAX package has none of them; each default
    # keeps its configs as they are)
    shared_d_ff: int = 0              # the shared expert's width; 0: d_ff
    held: int = 0                     # experts held here, ids 0 on (one rank's share); 0: all
    dropless: bool = False            # train and prefill route with no capacity


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
    # the port's own fields (granite-4.0-h's), each default a no-op: the
    # embedding's output and every residual branch scaled, the logits
    # divided, the softmax scale (0: 1 / sqrt(head_dim)), no positional
    # encoding in any attention layer
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attn_scale: float = 0.0
    nope: bool = False

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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_attn = sum(1 for k in self.layer_kinds() if k.startswith("attn"))
        n_mamba = sum(1 for k in self.layer_kinds() if k == MAMBA)
        p = v * d  # embed
        if not self.tie_embeddings:
            p += v * d
        q = self.num_heads * self.head_dim
        kv = self.num_kv_heads * self.head_dim
        attn_p = d * q + 2 * d * kv + q * d
        if self.qkv_bias:
            attn_p += q + 2 * kv
        p += n_attn * attn_p
        if self.mamba is not None:
            di = self.mamba.expand * d
            nheads = di // self.mamba.head_dim
            conv_dim = di + 2 * self.mamba.n_groups * self.mamba.d_state
            in_dim = 2 * di + 2 * self.mamba.n_groups * self.mamba.d_state + nheads
            mamba_p = d * in_dim + conv_dim * self.mamba.d_conv + di * d + nheads * 2 + di
            p += n_mamba * mamba_p
        n_blocks = self.num_layers
        mlp_p = (3 if self.mlp_gated else 2) * d * ff
        if self.moe is not None:
            n_moe = len([i for i in range(n_blocks) if (i % self.moe_every) == self.moe_every - 1])
            n_dense = n_blocks - n_moe
            p += n_dense * mlp_p
            # the experts held here (all, unless a share), the router over all
            held = self.moe.held or self.moe.num_experts
            p += n_moe * (held * mlp_p + d * self.moe.num_experts)
            if self.moe.shared_expert:
                p += n_moe * (3 if self.mlp_gated else 2) * d * (self.moe.shared_d_ff or ff)
        else:
            p += n_blocks * mlp_p
        p += (2 * n_blocks + 1) * d          # norms (2 per block + final)
        if self.enc_layers:
            de = self.enc_d_model or d
            enc_attn = 4 * de * de
            enc_mlp = (3 if self.mlp_gated else 2) * de * self.d_ff
            p += self.enc_layers * (enc_attn + enc_mlp + 2 * de)
            p += self.num_layers * (4 * d * de + d)   # decoder cross-attention
        return int(p)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp_p = (3 if self.mlp_gated else 2) * d * ff
        n_blocks = self.num_layers
        n_moe = len([i for i in range(n_blocks) if (i % self.moe_every) == self.moe_every - 1])
        E = self.moe.num_experts
        held = self.moe.held or E
        # a share of the experts: its even share of a token's top_k
        routed = self.moe.top_k if held == E else self.moe.top_k * held / E
        inactive = n_moe * (held - routed) * mlp_p
        return self.param_count() - int(inactive)

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/topology, tiny dims (the same
        rule as the JAX package, so both reduce a config identically)."""
        d = min(self.d_model, 128)
        hd = 32
        nh = max(2, min(4, self.num_heads)) if self.num_heads else 0
        nkv = max(1, min(nh or 1, max(1, self.num_kv_heads * nh // max(1, self.num_heads))))
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                          shared_d_ff=min(self.moe.shared_d_ff, 4 * d),
                          held=min(self.moe.held, 4))
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


# ---------------------------------------------------------------------------
# Input shapes (assigned): the dry-run's (arch x shape) table
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class LevelConfig:
    """One level of an aggregation tree's sync cascade (leaf-most first),
    paired by order with the levels of the ``comm.tree`` topology named by
    ``SyncConfig.topology``.  Periods must be nested: each level's period a
    multiple of the level below."""
    name: str
    period: int = 1
    compressor: str = "identity"      # see core/compressors.py registry
    compress_ratio: float = 0.05
    quant_bits: int = 8


@dataclass(frozen=True)
class SyncConfig:
    """How gradients (or replicas) are synchronized across worker groups.

    ``mode``: dense (plain mean), efbv (EF-BV compressed delta sync, Ch. 2),
    ef21 (nu = lambda), diana (nu = 1), local (Scafflix-style replicas that
    sync every ``sync_period`` steps), hier (Cohort-Squeeze: replicas per pod
    with a compressed inter-pod sync every ``sync_period`` steps, or an
    aggregation-tree cascade when ``levels`` is set).
    """
    mode: str = "dense"
    compressor: str = "topk_block"    # see core/compressors.py registry
    compress_ratio: float = 0.05      # k/d for sparsifiers
    quant_bits: int = 8
    sync_period: int = 1              # Scafflix E[1/p]
    personalization_alpha: float = 1.0  # FLIX alpha (1 = no personalization)
    # link topology preset (comm.topology.PRESETS, or comm.tree.TREE_PRESETS
    # when ``levels`` is set) that turns per-round bytes into a modelled time
    topology: str = "v5p_superpod"
    levels: Optional[Tuple[LevelConfig, ...]] = None
    # bucket fusion (comm.buckets): one fused compressor pass over the whole
    # tree; 0 = the per-leaf path
    bucket_size: int = 1 << 16
    # streamed codec tiles in the modelled round time; 0 = monolithic
    stream_tile_bytes: int = 1 << 20
    # fault injection (faults.model); None or all-zero rates keep every sync
    # path bit-identical to the faultless one
    faults: Optional[FaultConfig] = None


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    seq_len: int = 4096
    global_batch: int = 256
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"
    grad_clip: float = 1.0
    sync: SyncConfig = field(default_factory=SyncConfig)
    remat: str = "dots"               # none | dots | full
    grad_accum: int = 1               # microbatch accumulation steps
    seed: int = 0


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
    # every architecture of the JAX package (each module registers itself)
    from repro_torch.configs import (chameleon_34b, dbrx_132b,  # noqa: F401
                                     h2o_danube_1_8b, jamba_1_5_large_398b,
                                     llama4_scout_17b_a16e, mamba2_2_7b,
                                     nemotron_4_15b, qwen1_5_4b, qwen1_5_110b,
                                     seamless_m4t_large_v2)
    # and the port's own
    from repro_torch.configs import granite_4_0_h_small  # noqa: F401


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
