"""The ``ssm`` family: Mamba2 SSD layers, all alike, attention-free.

Mamba2 (arXiv:2405.21060) as published: each layer ``x +
out_proj(RMSNorm(SSD(...) * silu(z)))`` after an RMSNorm; ``in_proj`` gives
z, x, B, C and dt; a causal depthwise convolution and SiLU over (x, B, C);
dt = softplus(dt + dt_bias); A = -exp(a_log); the SSD computed by the
paper's chunked algorithm (its "minimal discrete" listing); a D skip; a
tied output.  What a family module exports: ``families/dense.py``.
"""
from __future__ import annotations

from dataclasses import replace

import torch
import torch.nn.functional as F

from perf_bench.harness.compare import MODEL_KEYS
from perf_bench.harness.weights import LeafSpec, mat, norm
from perf_bench.reference.model import layer_stack, mm, rmsnorm, ssd

POSITIONAL = False      # a recurrence: every position costs the same


def dims(cfg: dict) -> dict:
    m = cfg["mamba"]
    d_inner = m["expand"] * cfg["d_model"]
    n_heads = d_inner // m["head_dim"]
    conv_dim = d_inner + 2 * m["n_groups"] * m["d_state"]
    in_dim = 2 * d_inner + 2 * m["n_groups"] * m["d_state"] + n_heads
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim, in_dim=in_dim)


def block_leaves(cfg: dict) -> list:
    D, L, dt, f32 = cfg["d_model"], cfg["num_layers"], cfg["dtype"], "float32"
    m, dm = cfg["mamba"], dims(cfg)
    H = dm["n_heads"]
    pre = "blocks/pos0/mamba/"
    return [norm(cfg, "blocks/pos0/norm1/scale", D),
            mat(cfg, pre + "in_proj", (D, dm["in_dim"])),
            LeafSpec(pre + "conv_w", (L, m["d_conv"], dm["conv_dim"]), dt, "normal", 0.5, 0.5),
            LeafSpec(pre + "conv_b", (L, dm["conv_dim"]), dt, "zeros", 0.0, 0.5),
            LeafSpec(pre + "a_log", (L, H), f32, "a_log", 0.0, 1.0),
            LeafSpec(pre + "dt_bias", (L, H), f32, "const", -2.0, 1.0),
            LeafSpec(pre + "D", (L, H), f32, "const", 1.0, 1.0),
            norm(cfg, pre + "norm/scale", dm["d_inner"]),
            mat(cfg, pre + "out_proj", (dm["d_inner"], D))]


def program_fields(cfg: dict, base) -> dict:
    return dict({k: cfg[k] for k in MODEL_KEYS if k in cfg},
                mamba=replace(base.mamba, **cfg["mamba"]))


def layer(x, p: dict, cfg: dict, fp8: bool):
    m = cfg["mamba"]
    B, S, D = x.shape
    di = m["expand"] * D
    H, P, N, G, K = di // m["head_dim"], m["head_dim"], m["d_state"], m["n_groups"], m["d_conv"]
    eps = cfg["norm_eps"]
    h = rmsnorm(x, p["norm1/scale"], eps)
    zxbcdt = mm(h, p["mamba/in_proj"], fp8)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    w = p["mamba/conv_w"]                                           # (K, conv_dim)
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = F.silu(sum(xp[:, i: i + S] * w[i] for i in range(K)) + p["mamba/conv_b"])
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["mamba/dt_bias"])                        # (B, S, H)
    A = -torch.exp(p["mamba/a_log"])                                # (H,)
    heads_group = torch.arange(H, device=x.device) // (H // G)
    Bh = Bm.reshape(B, S, G, N)[:, :, heads_group]                     # (B, S, H, N)
    Ch = Cm.reshape(B, S, G, N)[:, :, heads_group]
    xh = xs.reshape(B, S, H, P)
    Q = m["chunk_size"]
    pad = (-S) % Q
    Xd, Ad = xh * dt[..., None], A * dt
    if pad:     # zeros after the sequence: a causal scan, so nothing earlier changes
        Xd, Ad = F.pad(Xd, (0, 0, 0, 0, 0, pad)), F.pad(Ad, (0, 0, 0, pad))
        Bh, Ch = F.pad(Bh, (0, 0, 0, 0, 0, pad)), F.pad(Ch, (0, 0, 0, 0, 0, pad))
    y = ssd(Xd, Ad, Bh, Ch, Q)[:, :S] + xh * p["mamba/D"][:, None]
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["mamba/norm/scale"], eps)
    return x + mm(y, p["mamba/out_proj"], fp8)


def hidden(params: dict, cfg: dict, tokens, fp8: bool = False, remat: bool = False):
    return layer_stack(params, cfg, tokens, layer, fp8, remat)


def body_weights(cfg: dict) -> int:
    """Multiply-adds of one token through every layer's weight products."""
    dm = dims(cfg)
    return cfg["num_layers"] * (cfg["d_model"] * dm["in_dim"] + dm["d_inner"] * cfg["d_model"])


def mixer_flops(cfg: dict, ctx: int) -> float:
    """The recurrence over the state, all layers: one multiply-add per state
    element to update it and one to read it out, at any context."""
    dm = dims(cfg)
    return cfg["num_layers"] * 4.0 * dm["n_heads"] * cfg["mamba"]["head_dim"] \
        * cfg["mamba"]["d_state"]


def reduced(cfg: dict) -> dict:
    # all its layers: a served token's rounding gap grows with depth, and
    # the float8 control's must reach the cell's limit
    return dict(num_layers=cfg["num_layers"], d_model=128, vocab_size=500,
                mamba=dict(cfg["mamba"], d_state=16, head_dim=16, chunk_size=8))
