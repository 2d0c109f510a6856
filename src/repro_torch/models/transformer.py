"""Decoder and encoder-decoder stacks for every architecture of the JAX
package (port of ``repro/models/transformer.py``).

The layer schedule is tiled from a period of length P (jamba's 7:1
mamba:attention interleave, llama4's 3:1 chunked:global iRoPE, MoE every
k-th layer); the params of each position-in-period are stacked over the
``num_layers / P`` periods under ``blocks/pos{j}``, exactly the JAX
package's tree, so the two flatten to the same delta block space.  Where
JAX scans over periods, the port loops.

A block is attention (global, sliding-window or chunked) or a Mamba2 SSD
mixer, then cross-attention to the encoder memory (encoder-decoder configs),
then a dense or MoE MLP.  ``forward_train`` and ``loss_fn`` run under
autograd (the trainer's backward); ``remat`` "dots" or "full" wraps each
period of blocks in ``torch.utils.checkpoint``, which changes memory, not
values.  Prefill uses the MoE capacity (tokens can be dropped), decode does
not (``no_drop``), as the reference does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (_dense_init, apply_rope, cross_entropy_loss,
                                       embed, init_embed, init_mlp, init_rmsnorm, mlp,
                                       rmsnorm, unembed)
from repro_torch.utils.device import make_generator, resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def period_info(cfg: ModelConfig):
    kinds = cfg.layer_kinds()
    base = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    P = _lcm(base, cfg.moe_every if cfg.moe else 1)
    assert cfg.num_layers % P == 0, (cfg.name, cfg.num_layers, P)
    n_periods = cfg.num_layers // P
    pos_kinds = kinds[:P]
    pos_moe = tuple(cfg.moe is not None and (j % cfg.moe_every) == cfg.moe_every - 1
                    for j in range(P))
    return P, n_periods, pos_kinds, pos_moe


def _attn_cfg(cfg: ModelConfig, kind: str) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, kind=kind, window=cfg.sliding_window,
                chunk=cfg.attn_chunk, qk_norm=cfg.qk_norm,
                # llama4 iRoPE: the global (non-chunked) layers are NoPE
                use_rope=not (cfg.attn_chunk > 0 and kind == "attn"),
                rope_theta=cfg.rope_theta)


def _moe_kw(cfg: ModelConfig) -> dict:
    return dict(num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor, act=cfg.mlp_act,
                gated=cfg.mlp_gated, shared_expert=cfg.moe.shared_expert)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(gen, cfg: ModelConfig, kind: str, use_moe: bool, dtype, device,
                lead) -> dict:
    d = cfg.d_model
    p = {"norm1": init_rmsnorm(d, dtype, device, lead)}
    if kind == MAMBA:
        p["mamba"] = mamba_lib.init_mamba(gen, d, cfg.mamba, dtype, device, lead)
    else:
        p["attn"] = attn_lib.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                            cfg.head_dim, cfg.qkv_bias, dtype, device,
                                            lead)
    if cfg.cross_attn:
        p["norm_x"] = init_rmsnorm(d, dtype, device, lead)
        p["xattn"] = attn_lib.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                             cfg.head_dim, False, dtype, device, lead)
    if cfg.d_ff > 0:
        p["norm2"] = init_rmsnorm(d, dtype, device, lead)
        if use_moe:
            p["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.moe.num_experts,
                                        cfg.mlp_gated, cfg.moe.shared_expert, dtype,
                                        device, lead)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_gated, dtype, device, lead)
    return p


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random weights from ``seed`` in the JAX package's tree layout:
    ``{"embed": {"tok", "unembed"}, "final_norm", "blocks": {"pos{j}": ...}}``
    with each block leaf stacked over periods, plus ``"encoder"`` and
    ``"vision_proj"`` where the config has them.  (Not the JAX package's
    values: load those with ``repro_torch.interop.params_from_jax``.)  On
    the ``meta`` device it builds the tree's structure alone, shapes and
    dtypes without storage, which a checkpoint is loaded into."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else make_generator(seed, device)
    dtype = model_dtype(cfg)
    P, n_periods, pos_kinds, pos_moe = period_info(cfg)
    params = {"embed": init_embed(gen, cfg.padded_vocab(), cfg.d_model, dtype,
                                  device, cfg.tie_embeddings),
              "final_norm": init_rmsnorm(cfg.d_model, dtype, device)}
    params["blocks"] = {f"pos{j}": _init_block(gen, cfg, pos_kinds[j], pos_moe[j], dtype,
                                               device, (n_periods,))
                        for j in range(P)}
    if cfg.enc_layers:
        de, lead = cfg.enc_d_model or cfg.d_model, (cfg.enc_layers,)
        params["encoder"] = {
            "blocks": {"norm1": init_rmsnorm(de, dtype, device, lead),
                       "attn": attn_lib.init_attention(
                           gen, de, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           False, dtype, device, lead),
                       "norm2": init_rmsnorm(de, dtype, device, lead),
                       "mlp": init_mlp(gen, de, cfg.d_ff, cfg.mlp_gated, dtype, device,
                                       lead)},
            "final_norm": init_rmsnorm(de, dtype, device)}
    if cfg.vision_tokens:
        params["vision_proj"] = _dense_init(gen, (cfg.d_model, cfg.d_model), dtype, device)
    return params


# ---------------------------------------------------------------------------
# Attention without a causal mask: cross-attention and the encoder
# ---------------------------------------------------------------------------
def _full_attention(q, k, v) -> torch.Tensor:
    """Non-causal softmax attention, (B, Sq, H*hd), through the tiled
    ``_flash_attention`` (kind "full"), as the reference's encoder and
    cross-attention: no (Sq, Sk) score matrix at any length."""
    B, Sq, H, hd = q.shape
    return attn_lib._flash_attention(q, k, v, "full", 0, 0).reshape(B, Sq, H * hd)


def _cross_attention(params, x, memory, cfg: ModelConfig) -> torch.Tensor:
    """Decoder x (B, Sq, D) attends to encoder memory (B, Sk, De)."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, Sq, H, hd)
    k = (memory @ params["wk"]).reshape(B, Sk, KV, hd)
    v = (memory @ params["wv"]).reshape(B, Sk, KV, hd)
    return _full_attention(q, k, v) @ params["wo"]


def _noncausal_self_attention(params, x, acfg: dict) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, hd = acfg["num_heads"], acfg["num_kv_heads"], acfg["head_dim"]
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    pos = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, pos, acfg["rope_theta"])
    k = apply_rope(k, pos, acfg["rope_theta"])
    return _full_attention(q, k, v) @ params["wo"]


def _encoder_block(cfg: ModelConfig, acfg: dict, x, bp):
    x = x + _noncausal_self_attention(bp["attn"], rmsnorm(bp["norm1"], x, cfg.norm_eps),
                                      acfg)
    return x + mlp(bp["mlp"], rmsnorm(bp["norm2"], x, cfg.norm_eps),
                   act=cfg.mlp_act, gated=cfg.mlp_gated)


def encode(params, cfg: ModelConfig, src_embeds: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """The encoder stack (seamless): bidirectional RoPE self-attention + MLP
    over precomputed frame embeddings (B, S, De) -> the memory (B, S, De)."""
    enc = params["encoder"]
    acfg = dict(_attn_cfg(cfg, "attn"), use_rope=True)
    x = src_embeds
    for i in range(cfg.enc_layers):
        bp = _period(enc["blocks"], i)
        if remat == "none" or not _needs_grad(x, bp):
            x = _encoder_block(cfg, acfg, x, bp)
        else:
            x = torch.utils.checkpoint.checkpoint(
                _encoder_block, cfg, acfg, x, bp, use_reentrant=False,
                preserve_rng_state=False)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# The stack over a whole sequence (train and prefill)
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, seq_len: int, enc_len: int = 0) -> dict:
    """The decode cache's leaves as ``meta`` tensors (shape and dtype, no
    storage), stacked over periods: ``{"layers": {"pos{j}": {"k", "v"} or
    {"ssm", "conv"}}}`` plus ``"enc_memory"`` for encoder-decoder configs."""
    dtype = model_dtype(cfg)
    P, n_periods, pos_kinds, _ = period_info(cfg)
    layers = {}
    for j, kind in enumerate(pos_kinds):
        if kind == MAMBA:
            spec = mamba_lib.mamba_cache_spec(cfg.d_model, cfg.mamba, batch, dtype)
        else:
            spec = {k: torch.empty(s, dtype=dtype, device="meta") for k, s in
                    attn_lib.cache_spec(_attn_cfg(cfg, kind), batch, seq_len).items()}
        layers[f"pos{j}"] = {k: t.expand((n_periods,) + tuple(t.shape))
                             for k, t in spec.items()}
    out = {"layers": layers}
    if cfg.enc_layers:
        out["enc_memory"] = torch.empty((batch, enc_len, cfg.enc_d_model or cfg.d_model),
                                        dtype=dtype, device="meta")
    return out


def _period(blocks: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], blocks)


def _ring_from_prefill(kv: dict, cfg_attn: dict, S: int, cache_len: int) -> dict:
    """Full prefill K/V (B,S,KV,hd) -> the decode cache: a ring of the last
    Sc positions with slot == pos % Sc for windowed kinds, a slot == pos cache
    padded to ``cache_len`` for the global kind."""
    kind = cfg_attn["kind"]
    if kind == "attn_swa":
        Sc = min(cache_len, cfg_attn["window"])
    elif kind == "attn_chunk":
        Sc = min(cache_len, cfg_attn["chunk"])
    else:
        Sc = max(cache_len, S)

    def ring(a):
        if S <= Sc:     # slot == pos, not yet wrapped: pad to capacity
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, Sc - S))
        tail = a[:, S - Sc:]
        # element j holds pos S-Sc+j, whose slot is (j + S) % Sc
        return torch.roll(tail, shifts=S % Sc, dims=1)

    return {"k": ring(kv["k"]), "v": ring(kv["v"])}


def _apply_block(bp, cfg: ModelConfig, kind: str, use_moe: bool, x, enc_out):
    """One block over the whole sequence -> (x, the MoE aux loss or None,
    the mixer's cache: the attention layer's full K/V or the Mamba layer's
    {ssm, conv})."""
    aux = None
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if kind == MAMBA:
        h, cache = mamba_lib.mamba_forward(bp["mamba"], h, cfg.mamba, cfg.d_model,
                                           return_cache=True)
    else:
        h, cache = attn_lib.attention_prefill(bp["attn"], h, cfg_attn=_attn_cfg(cfg, kind))
    x = x + h
    if cfg.cross_attn and enc_out is not None:
        x = x + _cross_attention(bp["xattn"], rmsnorm(bp["norm_x"], x, cfg.norm_eps),
                                 enc_out, cfg)
    if cfg.d_ff > 0:
        h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
        if use_moe:
            h, aux = moe_lib.moe_apply(bp["moe"], h, **_moe_kw(cfg))
        else:
            h = mlp(bp["mlp"], h, act=cfg.mlp_act, gated=cfg.mlp_gated)
        x = x + h
    return x, aux, cache


def _period_body(cfg: ModelConfig, x, bps, enc_out=None, on_cache=None):
    """One period of blocks over the whole sequence -> (x, the period's MoE
    aux loss, None without MoE).  ``on_cache(j, cache)`` receives each
    block's mixer cache, in layer order."""
    P, _, pos_kinds, pos_moe = period_info(cfg)
    aux = None
    for j in range(P):
        x, a, cache = _apply_block(bps[f"pos{j}"], cfg, pos_kinds[j], pos_moe[j], x,
                                   enc_out)
        if on_cache is not None:
            on_cache(j, cache)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _trunk(params, cfg: ModelConfig, x: torch.Tensor, enc_out=None, on_cache=None,
           remat: str = "none"):
    """Run every block over embedded inputs ``x`` (B, S, D) -> (final-normed
    hidden states, summed aux loss).  ``remat`` other than "none"
    recomputes each period in the backward (``torch.utils.checkpoint``); it
    takes no ``on_cache``."""
    n_periods = period_info(cfg)[1]
    auxes = []
    for i in range(n_periods):
        bps = _period(params["blocks"], i)
        if remat == "none" or not _needs_grad(x, bps):
            x, aux = _period_body(cfg, x, bps, enc_out, on_cache)
        else:
            # the blocks draw no random numbers: no RNG state to save, and
            # saving it would synchronize with the card every period
            x, aux = torch.utils.checkpoint.checkpoint(
                _period_body, cfg, x, bps, enc_out, use_reentrant=False,
                preserve_rng_state=False)
        auxes.append(aux)
    aux = torch.stack(auxes).sum() if cfg.moe else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _needs_grad(x: torch.Tensor, bps: dict) -> bool:
    """Whether autograd will record this period (else remat is moot)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(bps)))


def _inputs(params, cfg: ModelConfig, batch: dict, x, remat: str = "none"):
    """The vision splice (projected patch embeddings replace the first
    ``nv`` positions; a prompt shorter than nv yields nv positions, as in
    the reference) and the encoder memory -> (x, enc_out or None)."""
    if cfg.vision_tokens and "vision_embeds" in batch:
        ve, w = batch["vision_embeds"], params["vision_proj"]
        dt = torch.promote_types(ve.dtype, w.dtype)     # jnp's promotion of ``@``
        vis = ve.to(dt) @ w.to(dt)
        x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1)
    enc_out = None
    if cfg.enc_layers:
        enc_out = encode(params, cfg, batch["src_embeds"].to(x.dtype), remat)
    return x, enc_out


def forward_train(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """Full-sequence forward -> (logits (B, S, V_pad) at every position, the
    MoE aux loss summed over layers; 0 without MoE).
    ``batch["inputs_embeds"]``, when present, replaces the token embedding
    (the grad-accumulation step passes it); ``"vision_embeds"`` and
    ``"src_embeds"`` feed the vision stub and the encoder."""
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat {remat!r}")
    x = batch["inputs_embeds"] if "inputs_embeds" in batch else \
        embed(params["embed"], batch["tokens"])
    x, enc_out = _inputs(params, cfg, batch, x, remat)
    x, aux = _trunk(params, cfg, x, enc_out=enc_out, remat=remat)
    return unembed(params["embed"], x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """-> (ce + aux_loss_weight * aux, {"ce", "aux"}): mean next-token CE
    over the valid vocab plus the weighted MoE load-balance loss."""
    logits, aux = forward_train(params, cfg, batch, remat)
    ce = cross_entropy_loss(logits, batch["targets"], valid_vocab=cfg.vocab_size)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int = 0):
    """Full-prompt forward -> (last-position logits (B, 1, V_pad), cache).

    ``batch["tokens"]`` is (B, S) int.  The cache holds ``{"layers": ...,
    "pos": S}`` with ``pos`` a Python int: attention layers their K/V
    (ring-rolled to the window for SWA/chunked kinds), Mamba layers {ssm
    state, conv tail}; encoder-decoder configs add ``"enc_memory"``."""
    P, _, pos_kinds, _ = period_info(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cache_len = max(cache_len, S + 1)
    caches = {f"pos{j}": [] for j in range(P)}

    def keep(j, cache):
        if pos_kinds[j] != MAMBA:
            cache = _ring_from_prefill(cache, _attn_cfg(cfg, pos_kinds[j]), S, cache_len)
        caches[f"pos{j}"].append(cache)

    x, enc_out = _inputs(params, cfg, batch, embed(params["embed"], tokens))
    x, _ = _trunk(params, cfg, x, enc_out=enc_out, on_cache=keep)
    logits = unembed(params["embed"], x[:, -1:])
    layers = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
              for name, cs in caches.items()}
    cache = {"layers": layers, "pos": int(S)}
    if cfg.enc_layers:
        cache["enc_memory"] = enc_out
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token (B, 1) int; cache from ``prefill``.  Returns (logits (B,1,V_pad),
    cache): the K/V and Mamba state are updated IN PLACE and ``pos``
    advances.  MoE layers route without capacity drops."""
    P, n_periods, pos_kinds, pos_moe = period_info(cfg)
    pos = int(cache["pos"])
    x = embed(params["embed"], token)
    enc_memory = cache.get("enc_memory")
    acfgs = {j: _attn_cfg(cfg, kind) for j, kind in enumerate(pos_kinds) if kind != MAMBA}
    biases = {j: attn_lib.decode_bias(a, cache["layers"][f"pos{j}"]["k"].shape[2], pos,
                                      x.device) for j, a in acfgs.items()}
    for i in range(n_periods):
        bps = _period(params["blocks"], i)
        for j in range(P):
            bp = bps[f"pos{j}"]
            lc = cache["layers"][f"pos{j}"]
            h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
            if pos_kinds[j] == MAMBA:
                h, new = mamba_lib.mamba_decode(
                    bp["mamba"], h, {"ssm": lc["ssm"][i], "conv": lc["conv"][i]},
                    cfg.mamba, cfg.d_model)
                lc["ssm"][i].copy_(new["ssm"])
                lc["conv"][i].copy_(new["conv"])
            else:
                h, _ = attn_lib.attention_decode(
                    bp["attn"], h, {"k": lc["k"][i], "v": lc["v"][i]}, pos,
                    cfg_attn=acfgs[j], bias=biases[j])
            x = x + h
            if cfg.cross_attn and enc_memory is not None:
                x = x + _cross_attention(bp["xattn"], rmsnorm(bp["norm_x"], x, cfg.norm_eps),
                                         enc_memory, cfg)
            if cfg.d_ff > 0:
                h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
                if pos_moe[j]:
                    h, _ = moe_lib.moe_ffn(bp["moe"], h, **_moe_kw(cfg), no_drop=True)
                else:
                    h = mlp(bp["mlp"], h, act=cfg.mlp_act, gated=cfg.mlp_gated)
                x = x + h
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x)
    cache["pos"] = pos + 1
    return logits, cache
