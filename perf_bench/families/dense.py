"""The ``dense`` family: Llama-style decoder blocks, all alike.

H2O-Danube (arXiv:2401.16818) as published: pre-RMSNorm, grouped-query
attention with rotary embeddings (the two halves of a head rotated as a
pair) and Mistral's sliding window (a query sees the keys no more than
``window - 1`` positions back), a SwiGLU MLP, an untied output matrix.

What ``perf_bench/families/<family>.py`` exports, found by the
configuration file's ``family``:

* ``block_leaves(cfg)``: the blocks' ``LeafSpec``s (``harness/weights.py``
  adds the embedding, the final norm and an untied output);
* ``program_fields(cfg, base)``: the program's ``ModelConfig`` fields the
  file states, applied to the registered architecture ``base``;
* ``hidden(params, cfg, tokens, fp8, remat)``: the plain f32 forward to the
  final-normed hidden states (optionally ``logits`` too);
* ``body_weights(cfg)``, ``mixer_flops(cfg, ctx)`` and ``POSITIONAL``
  (whether a token's flops depend on its position) for ``metrics/counts.py``;
* ``reduced(cfg)``: the sizes the CPU tests run it at.
"""
from __future__ import annotations

import torch.nn.functional as F

from perf_bench.harness.compare import MODEL_KEYS
from perf_bench.harness.weights import mat, norm
from perf_bench.reference.model import attention, layer_stack, mm, rmsnorm, rope

POSITIONAL = True       # attention over the positions a token sees


def block_leaves(cfg: dict) -> list:
    D, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, Fd = cfg["head_dim"], cfg["d_ff"]
    return [norm(cfg, "blocks/pos0/norm1/scale", D),
            mat(cfg, "blocks/pos0/attn/wq", (D, H * hd)),
            mat(cfg, "blocks/pos0/attn/wk", (D, KV * hd)),
            mat(cfg, "blocks/pos0/attn/wv", (D, KV * hd)),
            mat(cfg, "blocks/pos0/attn/wo", (H * hd, D)),
            norm(cfg, "blocks/pos0/norm2/scale", D),
            mat(cfg, "blocks/pos0/mlp/w_in", (D, Fd)),
            mat(cfg, "blocks/pos0/mlp/w_gate", (D, Fd)),
            mat(cfg, "blocks/pos0/mlp/w_out", (Fd, D))]


def program_fields(cfg: dict, base) -> dict:
    return {k: cfg[k] for k in MODEL_KEYS if k in cfg}


def layer(x, p: dict, cfg: dict, fp8: bool):
    B, S, _ = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    h = rmsnorm(x, p["norm1/scale"], eps)
    q = mm(h, p["attn/wq"], fp8).view(B, S, H, hd)
    k = mm(h, p["attn/wk"], fp8).view(B, S, KV, hd)
    v = mm(h, p["attn/wv"], fp8).view(B, S, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    x = x + mm(attention(q, k, v, cfg.get("sliding_window", 0)), p["attn/wo"], fp8)
    h = rmsnorm(x, p["norm2/scale"], eps)
    g = F.silu(mm(h, p["mlp/w_gate"], fp8)) * mm(h, p["mlp/w_in"], fp8)
    return x + mm(g, p["mlp/w_out"], fp8)


def hidden(params: dict, cfg: dict, tokens, fp8: bool = False, remat: bool = False):
    return layer_stack(params, cfg, tokens, layer, fp8, remat)


def body_weights(cfg: dict) -> int:
    """Multiply-adds of one token through every layer's weight products."""
    D = cfg["d_model"]
    q = cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    return cfg["num_layers"] * (D * q + 2 * D * kv + q * D + 3 * D * cfg["d_ff"])


def mixer_flops(cfg: dict, ctx: int) -> float:
    """QK and PV once over the keys a token at context ``ctx`` sees (the
    sliding window's at most), all layers."""
    w = cfg.get("sliding_window") or ctx
    return cfg["num_layers"] * 4.0 * cfg["num_heads"] * cfg["head_dim"] * min(ctx, w)


def reduced(cfg: dict) -> dict:
    return dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                vocab_size=512, sliding_window=24)
