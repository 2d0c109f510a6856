"""The ``hybrid`` family: Granite-4.0-H's period of Mamba2 and NoPE
attention layers, each layer's MLP a dropless mixture of experts beside a
shared expert.

Granite-4.0-H (``model_type`` granitemoehybrid, the published config.json)
as published: the embedding's output times ``embedding_multiplier``; each
layer ``x + r * mixer(RMSNorm(x))``, then ``x + r * moe(RMSNorm(x))`` with
``r`` the ``residual_multiplier``; the mixers follow ``layer_types`` (one
period in the file), Mamba2 (as ``families/ssm.py``'s, with its conv bias,
from the shared ``ssd``) or grouped-query attention with no positional
encoding (``position_embedding_type`` "nope") and the softmax scale
``attention_multiplier``; the MoE a router over ``router_experts``
experts, a softmax over each token's ``num_experts_per_tok`` largest
logits (no capacity, nothing dropped), SwiGLU experts of width
``intermediate_size``, and a shared SwiGLU expert of width
``shared_intermediate_size`` added to their sum; a tied output, the logits
divided by ``logits_scaling``.

The configuration holds a share of the experts (``num_local_experts``
held, ids 0 on, of the router's ``router_experts``): the reference adds
the gated outputs of those experts alone, as the program does.  The
router's weights are f32, as the program keeps them.  Each block is
recomputed in the backward with ``remat``.  What a family module exports:
``families/dense.py``; beside it ``held_share`` (the held experts' even
share of a token's assignments) and ``moe_flops`` for the expert layer's
reader.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perf_bench.harness.weights import LeafSpec
from perf_bench.reference.model import _FakeFP8, attention, mm, rmsnorm, rope, ssd

POSITIONAL = True       # its attention layers see every earlier position
PROGRAM_KINDS = {"mamba": "mamba", "attention": "attn"}     # the port's layer kinds


def periods(cfg: dict) -> int:
    return cfg["num_layers"] // len(cfg["layer_types"])


def dims(cfg: dict) -> dict:
    D = cfg["d_model"]
    d_inner = cfg["mamba_expand"] * D
    n_heads = d_inner // cfg["mamba_d_head"]
    GN = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=d_inner + 2 * GN,
                in_dim=2 * d_inner + 2 * GN + n_heads, head_dim=D // cfg["num_attention_heads"])


def _mat(cfg: dict, path: str, shape: tuple) -> LeafSpec:
    """A weight (..., fan_in, fan_out) stacked over the periods:
    N(0, 1/fan_in)."""
    std = 1.0 / math.sqrt(shape[-2])
    return LeafSpec(path, (periods(cfg),) + shape, cfg["dtype"], "normal", std, std)


def _norm(cfg: dict, path: str, dim: int) -> LeafSpec:
    return LeafSpec(path, (periods(cfg), dim), cfg["dtype"], "ones", 0.0, 1.0)


def block_leaves(cfg: dict) -> list:
    D, P, dt, f32 = cfg["d_model"], periods(cfg), cfg["dtype"], "float32"
    dm = dims(cfg)
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], dm["head_dim"]
    n, Fe, Fs = cfg["num_local_experts"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    out = []
    for j, kind in enumerate(cfg["layer_types"]):
        pre = f"blocks/pos{j}/"
        out.append(_norm(cfg, pre + "norm1/scale", D))
        if kind == "mamba":
            m, Hm = pre + "mamba/", dm["n_heads"]
            out += [_mat(cfg, m + "in_proj", (D, dm["in_dim"])),
                    LeafSpec(m + "conv_w", (P, cfg["mamba_d_conv"], dm["conv_dim"]), dt,
                             "normal", 0.5, 0.5),
                    LeafSpec(m + "conv_b", (P, dm["conv_dim"]), dt, "zeros", 0.0, 0.5),
                    LeafSpec(m + "a_log", (P, Hm), f32, "a_log", 0.0, 1.0),
                    LeafSpec(m + "dt_bias", (P, Hm), f32, "const", -2.0, 1.0),
                    LeafSpec(m + "D", (P, Hm), f32, "const", 1.0, 1.0),
                    _norm(cfg, m + "norm/scale", dm["d_inner"]),
                    _mat(cfg, m + "out_proj", (dm["d_inner"], D))]
        else:
            a = pre + "attn/"
            out += [_mat(cfg, a + "wq", (D, H * hd)), _mat(cfg, a + "wk", (D, KV * hd)),
                    _mat(cfg, a + "wv", (D, KV * hd)), _mat(cfg, a + "wo", (H * hd, D))]
        e = pre + "moe/"
        router = 1.0 / math.sqrt(D)         # unit-spread router logits
        out += [_norm(cfg, pre + "norm2/scale", D),
                LeafSpec(e + "router", (P, D, cfg["router_experts"]), f32, "normal", router,
                         router),
                _mat(cfg, e + "w_in", (n, D, Fe)), _mat(cfg, e + "w_gate", (n, D, Fe)),
                _mat(cfg, e + "w_out", (n, Fe, D)),
                _mat(cfg, e + "shared/w_in", (D, Fs)), _mat(cfg, e + "shared/w_gate", (D, Fs)),
                _mat(cfg, e + "shared/w_out", (Fs, D))]
    return out


def program_fields(cfg: dict, base) -> dict:
    H = cfg["num_attention_heads"]
    return dict(
        num_layers=cfg["num_layers"], d_model=cfg["d_model"], num_heads=H,
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["d_model"] // H,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"], norm_eps=cfg["norm_eps"],
        tie_embeddings=cfg["tie_embeddings"], dtype=cfg["dtype"],
        layer_pattern=tuple(PROGRAM_KINDS[k] for k in cfg["layer_types"]),
        mamba=replace(base.mamba, d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                      expand=cfg["mamba_expand"], head_dim=cfg["mamba_d_head"],
                      n_groups=cfg["mamba_n_groups"], chunk_size=cfg["mamba_chunk_size"]),
        moe=replace(base.moe, num_experts=cfg["router_experts"],
                    top_k=cfg["num_experts_per_tok"], shared_expert=True,
                    shared_d_ff=cfg["shared_intermediate_size"],
                    held=cfg["num_local_experts"],
                    dropless=True, aux_loss_weight=cfg["router_aux_loss_coef"]),
        embedding_multiplier=cfg["embedding_multiplier"],
        residual_multiplier=cfg["residual_multiplier"], logits_scaling=cfg["logits_scaling"],
        attn_scale=cfg["attention_multiplier"],
        nope=cfg["position_embedding_type"] == "nope")


def _mamba(h, p: dict, cfg: dict, fp8: bool):
    """The Mamba2 mixer's output (``families/ssm.py``'s layer, no residual)."""
    B, S, D = h.shape
    dm = dims(cfg)
    di, H, P = dm["d_inner"], dm["n_heads"], cfg["mamba_d_head"]
    N, G, K = cfg["mamba_d_state"], cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    z, xBC, dt = torch.split(mm(h, p["mamba/in_proj"], fp8), [di, di + 2 * G * N, H], dim=-1)
    w = p["mamba/conv_w"]                                           # (K, conv_dim)
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = F.silu(sum(xp[:, i: i + S] * w[i] for i in range(K)) + p["mamba/conv_b"])
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["mamba/dt_bias"])                        # (B, S, H)
    A = -torch.exp(p["mamba/a_log"])
    heads_group = torch.arange(H, device=h.device) // (H // G)
    Bh = Bm.reshape(B, S, G, N)[:, :, heads_group]
    Ch = Cm.reshape(B, S, G, N)[:, :, heads_group]
    xh = xs.reshape(B, S, H, P)
    Q = cfg["mamba_chunk_size"]
    pad = (-S) % Q
    Xd, Ad = xh * dt[..., None], A * dt
    if pad:     # zeros after the sequence: a causal scan, so nothing earlier changes
        Xd, Ad = F.pad(Xd, (0, 0, 0, 0, 0, pad)), F.pad(Ad, (0, 0, 0, pad))
        Bh, Ch = F.pad(Bh, (0, 0, 0, 0, 0, pad)), F.pad(Ch, (0, 0, 0, 0, 0, pad))
    y = ssd(Xd, Ad, Bh, Ch, Q)[:, :S] + xh * p["mamba/D"][:, None]
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["mamba/norm/scale"], cfg["norm_eps"])
    return mm(y, p["mamba/out_proj"], fp8)


def _attention(h, p: dict, cfg: dict, fp8: bool):
    B, S, _ = h.shape
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], dims(cfg)["head_dim"]
    q = mm(h, p["attn/wq"], fp8).view(B, S, H, hd)
    k = mm(h, p["attn/wk"], fp8).view(B, S, KV, hd)
    v = mm(h, p["attn/wv"], fp8).view(B, S, KV, hd)
    if cfg["position_embedding_type"] != "nope":
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    # ``attention`` divides the scores by sqrt(hd): the queries carry the
    # rest of the published scale
    q = q * (cfg["attention_multiplier"] * math.sqrt(hd))
    return mm(attention(q, k, v, 0), p["attn/wo"], fp8)


def _swiglu(h, w_in, w_gate, w_out, fp8: bool):
    return mm(F.silu(mm(h, w_gate, fp8)) * mm(h, w_in, fp8), w_out, fp8)


def _moe(h, p: dict, cfg: dict, fp8: bool, e0: int = 0):
    """The held experts' (ids ``e0`` on) gated outputs plus the shared
    expert's.  A token's gates: the softmax over its ``num_experts_per_tok``
    largest router logits; each held expert runs on every token, weighted by
    its gate (0 where the token did not choose it), so nothing is dropped."""
    K = cfg["num_experts_per_tok"]
    top, idx = torch.topk(mm(h, p["moe/router"], fp8), K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = _swiglu(h, p["moe/shared/w_in"], p["moe/shared/w_gate"], p["moe/shared/w_out"], fp8)
    for e in range(cfg["num_local_experts"]):
        g = (gates * (idx == e0 + e)).sum(-1, keepdim=True)
        out = out + g * _swiglu(h, p["moe/w_in"][e], p["moe/w_gate"][e], p["moe/w_out"][e], fp8)
    return out


def block(x, p: dict, cfg: dict, kind: str, fp8: bool):
    r, eps = cfg["residual_multiplier"], cfg["norm_eps"]
    h = rmsnorm(x, p["norm1/scale"], eps)
    x = x + r * (_mamba(h, p, cfg, fp8) if kind == "mamba" else _attention(h, p, cfg, fp8))
    return x + r * _moe(rmsnorm(x, p["norm2/scale"], eps), p, cfg, fp8)


def hidden(params: dict, cfg: dict, tokens, fp8: bool = False, remat: bool = False):
    """The embedding times its multiplier, every block in order (each
    recomputed in the backward with ``remat``), the final norm."""
    x = params["embed/tok"][tokens] * cfg["embedding_multiplier"]
    if fp8:
        x = _FakeFP8.apply(x)
    for i in range(periods(cfg)):
        for j, kind in enumerate(cfg["layer_types"]):
            pre = f"blocks/pos{j}/"
            names = [k[len(pre):] for k in params if k.startswith(pre)]

            def one(x, *leaves, names=names, kind=kind):
                y = block(x, dict(zip(names, leaves)), cfg, kind, fp8)
                return _FakeFP8.apply(y) if fp8 else y

            leaves = [params[pre + k][i] for k in names]
            x = (checkpoint(one, x, *leaves, use_reentrant=False) if remat
                 else one(x, *leaves))
    return rmsnorm(x, params["final_norm/scale"], cfg["norm_eps"])


def logits(params: dict, cfg: dict, h, fp8: bool = False):
    """The tied table's logits over the real vocabulary, divided by
    ``logits_scaling``."""
    return mm(h, params["embed/tok"].T[:, : cfg["vocab_size"]], fp8) / cfg["logits_scaling"]


def held_share(cfg: dict) -> float:
    """The held experts' even share of a token's assignments: k * n / E."""
    return cfg["num_experts_per_tok"] * cfg["num_local_experts"] / cfg["router_experts"]


def moe_weights(cfg: dict, held_per_token: float) -> float:
    """Multiply-adds of one token through one expert layer's router, shared
    expert and ``held_per_token`` held-expert assignments."""
    D = cfg["d_model"]
    return (D * cfg["router_experts"] + 3 * D * cfg["shared_intermediate_size"]
            + held_per_token * 3 * D * cfg["intermediate_size"])


def moe_flops(cfg: dict, tokens: float, held_rows: float) -> float:
    """Forward flops of expert-layer calls over ``tokens`` token-layers
    whose held experts computed ``held_rows`` assignments."""
    return 2.0 * tokens * moe_weights(cfg, held_rows / tokens)


def body_weights(cfg: dict) -> float:
    """Multiply-adds of one token through every layer's weight products,
    the held experts at their even share of its assignments."""
    D, dm = cfg["d_model"], dims(cfg)
    q = cfg["num_attention_heads"] * dm["head_dim"]
    kv = cfg["num_key_value_heads"] * dm["head_dim"]
    mixers = {"mamba": D * dm["in_dim"] + dm["d_inner"] * D, "attention": 2 * D * q + 2 * D * kv}
    per_period = sum(mixers[k] + moe_weights(cfg, held_share(cfg)) for k in cfg["layer_types"])
    return periods(cfg) * per_period


def mixer_flops(cfg: dict, ctx: int) -> float:
    """QK and PV once over the ``ctx`` positions a token sees in each
    attention layer; the recurrence over the state (a multiply-add per
    state element to update it, one to read it) in each Mamba2 layer."""
    dm = dims(cfg)
    per = {"mamba": 4.0 * dm["n_heads"] * cfg["mamba_d_head"] * cfg["mamba_d_state"],
           "attention": 4.0 * cfg["num_attention_heads"] * dm["head_dim"] * ctx}
    return periods(cfg) * sum(per[k] for k in cfg["layer_types"])


def reduced(cfg: dict) -> dict:
    # one whole period; the router's experts, a token's experts and the
    # share held as published, every width cut
    return dict(num_layers=len(cfg["layer_types"]), num_hidden_layers=len(cfg["layer_types"]),
                d_model=128, hidden_size=128, vocab_size=512, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=16, shared_intermediate_size=32,
                mamba_n_heads=16, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8)
