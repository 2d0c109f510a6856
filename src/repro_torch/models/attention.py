"""GQA attention with global / sliding-window / chunked-local variants
(port of ``repro/models/attention.py:25-71, 195-265``).

Prefill is a plain masked softmax in f32 over the whole (Sq, Sk) score
matrix; the JAX package's ``_flash_attention`` is a tiled jnp version of
the same function (not a Pallas kernel), so the two agree to rounding.
Decode runs one query token against the cache: a ring buffer of the window
for SWA/chunked layers, a slot == position cache for global ones.

Shapes: x (B, S, D); q heads H, kv heads KV (GQA groups G = H / KV).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import _dense_init, apply_rope, l2norm

NEG_INF = -1e30


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, bias: bool, dtype, device, lead=()) -> dict:
    q_dim, kv_dim = num_heads * head_dim, num_kv_heads * head_dim
    p = {"wq": _dense_init(gen, (d_model, q_dim), dtype, device, lead=lead),
         "wk": _dense_init(gen, (d_model, kv_dim), dtype, device, lead=lead),
         "wv": _dense_init(gen, (d_model, kv_dim), dtype, device, lead=lead),
         "wo": _dense_init(gen, (q_dim, d_model), dtype, device, lead=lead)}
    if bias:
        for name, dim in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            p[name] = torch.zeros(tuple(lead) + (dim,), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, num_heads, num_kv_heads, head_dim, qk_norm,
                 use_rope, positions, rope_theta):
    B, S, _ = x.shape
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    if qk_norm:
        q, k = l2norm(q), l2norm(k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _mask(q_idx, k_idx, kind: str, window: int, chunk: int) -> torch.Tensor:
    """(Sq, Sk) additive f32 mask: 0 where a query may see a key."""
    if kind == "full":
        return torch.zeros((q_idx.shape[0], k_idx.shape[0]), dtype=torch.float32,
                           device=q_idx.device)
    ok = q_idx[:, None] >= k_idx[None, :]
    if kind == "attn_swa":
        ok = ok & (q_idx[:, None] - k_idx[None, :] < window)
    elif kind == "attn_chunk":
        ok = ok & ((q_idx[:, None] // chunk) == (k_idx[None, :] // chunk))
    zero = torch.zeros((), dtype=torch.float32, device=q_idx.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _attend(q, k, v, bias) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v in f32; q (B,Sq,H,hd), k/v
    (B,Sk,KV,hd), bias broadcastable to (Sq, Sk).  -> (B, Sq, H*hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bnkh->bqkgn", qf, k.float())
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgn,bnkh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H * hd).to(q.dtype)


def attention_prefill(params, x, *, cfg_attn: dict):
    """Causal attention over the whole prompt -> (output, cache{k, v})."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg_attn["num_heads"], cfg_attn["num_kv_heads"],
                           cfg_attn["head_dim"], cfg_attn["qk_norm"], cfg_attn["use_rope"],
                           positions, cfg_attn["rope_theta"])
    idx = torch.arange(S, device=x.device)
    bias = _mask(idx, idx, cfg_attn["kind"], cfg_attn["window"], cfg_attn["chunk"])
    out = _attend(q, k, v, bias) @ params["wo"]
    return out, {"k": k, "v": v}


def cache_spec(cfg_attn: dict, batch: int, seq_len: int) -> dict:
    """Decode-cache shapes of one attention layer (SWA/chunked: the window)."""
    kind = cfg_attn["kind"]
    if kind == "attn_swa":
        S = min(seq_len, cfg_attn["window"])
    elif kind == "attn_chunk":
        S = min(seq_len, cfg_attn["chunk"])
    else:
        S = seq_len
    shape = (batch, S, cfg_attn["num_kv_heads"], cfg_attn["head_dim"])
    return {"k": shape, "v": shape}


def decode_bias(cfg_attn: dict, Sc: int, pos: int, device) -> torch.Tensor:
    """(Sc,) additive mask of the live cache slots after writing position
    ``pos`` into slot ``pos % Sc``."""
    slot = pos % Sc
    idx = torch.arange(Sc, device=device)
    age = (slot - idx) % Sc                      # 0 = newest
    written = idx <= min(pos, Sc - 1)
    kind = cfg_attn["kind"]
    if kind == "attn_swa":
        live = age < cfg_attn["window"]
    elif kind == "attn_chunk":
        live = ((pos - age) // cfg_attn["chunk"]) == (pos // cfg_attn["chunk"])
    else:
        live = torch.ones_like(written)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(written & live, zero, torch.full_like(zero, NEG_INF))


def attention_decode(params, x, cache: dict, pos: int, *, cfg_attn: dict,
                     bias=None):
    """One-token decode.  x (B,1,D); cache{k,v} (B,Sc,KV,hd); ``pos`` tokens
    already in context.  Writes the new K/V into slot ``pos % Sc`` of the
    cache IN PLACE (the port updates its cache rather than copying it) and
    returns (out, cache).  ``bias`` is ``decode_bias(...)``, computed once per
    step by the caller; derived here when omitted."""
    B = x.shape[0]
    H, KV, hd = cfg_attn["num_heads"], cfg_attn["num_kv_heads"], cfg_attn["head_dim"]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, H, KV, hd, cfg_attn["qk_norm"],
                                   cfg_attn["use_rope"], positions, cfg_attn["rope_theta"])
    k, v = cache["k"], cache["v"]
    Sc = k.shape[1]
    slot = pos % Sc
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    if bias is None:
        bias = decode_bias(cfg_attn, Sc, pos, x.device)
    out = _attend(q, k, v, bias[None, :]) @ params["wo"]
    return out, cache
