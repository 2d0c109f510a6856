"""Shared neural layers (port of ``repro/models/layers.py``): RMSNorm with
f32 inside, split-halves rotary embeddings, gated/plain MLPs, embeddings.

Functional style on plain dicts of tensors, as in the JAX package: ``init_*``
builds a param subtree, the apply functions take ``(params, inputs)``.  A
``lead`` shape stacks a leaf over layers (the period stacking of
``transformer.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None, lead=()) -> torch.Tensor:
    """Normal(0, std) weights, std = scale or 1/sqrt(fan_in) of ``shape``
    (``lead`` dims stack independent draws)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def init_rmsnorm(dim: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones(tuple(lead) + (dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free L2 norm over the last dim (QK-norm)."""
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).  Split-halves
    layout: the first and second halves of hd are the rotated pair."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype, device, lead=()) -> dict:
    p = {"w_in": _dense_init(gen, (d_model, d_ff), dtype, device, lead=lead),
         "w_out": _dense_init(gen, (d_ff, d_model), dtype, device, lead=lead)}
    if gated:
        p["w_gate"] = _dense_init(gen, (d_model, d_ff), dtype, device, lead=lead)
    return p


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h)
    if act == "gelu":          # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h, approximate="tanh")
    if act == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(act)


def mlp(params: dict, x: torch.Tensor, act: str = "silu", gated: bool = True) -> torch.Tensor:
    h = x @ params["w_in"]
    if gated:
        if act not in ("silu", "gelu"):
            raise ValueError(act)
        h = _act(x @ params["w_gate"], act) * h
    else:
        h = _act(h, act)
    return h @ params["w_out"]


def init_embed(gen, vocab: int, d_model: int, dtype, device, tie: bool) -> dict:
    p = {"tok": _dense_init(gen, (vocab, d_model), dtype, device, scale=0.02)}
    if not tie:
        p["unembed"] = _dense_init(gen, (d_model, vocab), dtype, device, scale=0.02)
    return p


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["tok"].T


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, ignore: int = -1,
                       valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE in f32.  logits (..., V), targets (...,) int;
    ``valid_vocab`` masks padded vocab rows out of the partition function."""
    logits = logits.float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        dead = torch.arange(logits.shape[-1], device=logits.device) >= valid_vocab
        logits = logits.masked_fill(dead, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    mask = (targets != ignore).float()
    # an ignored target may be out of range: gather at 0, masked out below
    idx = torch.where(targets != ignore, targets, torch.zeros_like(targets))
    gold = logits.gather(-1, idx[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
