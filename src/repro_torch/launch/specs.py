"""Stand-ins for every model input of a dry-run cell (port of
``repro/launch/specs.py``).

A spec is a ``meta`` tensor: a shape and a dtype, no storage, so the
specs of a full-width cell allocate nothing.  Shapes come from the
``INPUT_SHAPES`` table; the multimodal stubs take precomputed frame / patch
embeddings, as in the reference.  Dtypes are the reference's: int32 tokens,
the model dtype for embeddings and caches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models import cache_specs, model_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embeds(cfg: ModelConfig, B: int, S: int) -> dict:
    dtype = model_dtype(cfg)
    specs = {}
    if cfg.vision_tokens:
        specs["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model), dtype)
    if cfg.enc_layers:
        # audio frames / source length: the target length of the assigned shape
        specs["src_embeds"] = _meta((B, S, cfg.enc_d_model or cfg.d_model), dtype)
    return specs


def train_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _meta((B, S), torch.int32), "targets": _meta((B, S), torch.int32),
            **_embeds(cfg, B, S)}


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _meta((B, S), torch.int32), **_embeds(cfg, B, S)}


def decode_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """One new token against a cache of ``shape.seq_len`` context.  The
    cache's position is a host int in the port (the reference's int32
    ``cache["pos"]`` leaf), so it has no spec."""
    B, S = shape.global_batch, shape.seq_len
    enc_len = min(S, 32768) if cfg.enc_layers else 0
    return {"token": _meta((B, 1), torch.int32),
            "cache": cache_specs(cfg, B, S, enc_len=enc_len)}


def input_specs(cfg: ModelConfig, shape) -> dict:
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def skip_reason(cfg: ModelConfig, shape_name: str):
    """Why a (arch, shape) combination is skipped, or None if it runs."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return (f"{cfg.name}: full quadratic attention — 500k decode KV cache "
                "is out of scope per the assignment (no SWA/chunked/SSM variant)")
    if cfg.moe is not None and (cfg.moe.dropless or cfg.moe.held):
        return (f"{cfg.name}: dropless routing and held expert shares run on one "
                "device only; the mesh's expert-parallel paths route with a capacity")
    return None
