"""Dense decoder stack: init, full-sequence forward, prefill, decode (port
of ``repro/models/transformer.py:43-143, 280-322, 325-489``).

The layer schedule is tiled from a period of length P; the params of each
position-in-period are stacked over the ``num_layers / P`` periods under
``blocks/pos{j}``, exactly the JAX package's tree, so the two flatten to the
same delta block space.  Where JAX scans over periods, the port loops.

The port runs decoder-only attention models.  ``forward_train`` and
``loss_fn`` run under autograd (the trainer's backward); ``remat`` "dots"
or "full" wraps each period of blocks in ``torch.utils.checkpoint``, which
changes memory, not values.  MoE, Mamba and encoder-decoder / vision configs raise
``NotImplementedError``: they are ROADMAP Queue 1, item 4 (other
architectures).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (cross_entropy_loss, embed, init_embed,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       unembed)
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


def require_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    what = []
    if cfg.moe is not None:
        what.append("MoE")
    if cfg.mamba is not None or MAMBA in cfg.layer_kinds():
        what.append("Mamba")
    if cfg.enc_layers or cfg.cross_attn:
        what.append("encoder-decoder")
    if cfg.vision_tokens:
        what.append("vision")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} layers are not ported yet "
            f"(ROADMAP.md Queue 1, item 4: other architectures)")


def _attn_cfg(cfg: ModelConfig, kind: str) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, kind=kind, window=cfg.sliding_window,
                chunk=cfg.attn_chunk, qk_norm=cfg.qk_norm,
                use_rope=not (cfg.attn_chunk > 0 and kind == "attn"),
                rope_theta=cfg.rope_theta)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init_block(gen, cfg: ModelConfig, dtype, device, lead) -> dict:
    d = cfg.d_model
    p = {"norm1": init_rmsnorm(d, dtype, device, lead),
         "attn": attn_lib.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                         cfg.head_dim, cfg.qkv_bias, dtype, device,
                                         lead)}
    if cfg.d_ff > 0:
        p["norm2"] = init_rmsnorm(d, dtype, device, lead)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_gated, dtype, device, lead)
    return p


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random weights from ``seed`` in the JAX package's tree layout:
    ``{"embed": {"tok", "unembed"}, "final_norm", "blocks": {"pos{j}": ...}}``
    with each block leaf stacked over periods.  (Not the JAX package's
    values: load those with ``repro_torch.interop.params_from_jax``.)  On
    the ``meta`` device it builds the tree's structure alone, shapes and
    dtypes without storage, which a checkpoint is loaded into."""
    require_supported(cfg)
    device = resolve_device(device)
    gen = None if device.type == "meta" else make_generator(seed, device)
    dtype = model_dtype(cfg)
    P, n_periods, _, _ = period_info(cfg)
    params = {"embed": init_embed(gen, cfg.padded_vocab(), cfg.d_model, dtype,
                                  device, cfg.tie_embeddings),
              "final_norm": init_rmsnorm(cfg.d_model, dtype, device)}
    params["blocks"] = {f"pos{j}": _init_block(gen, cfg, dtype, device, (n_periods,))
                        for j in range(P)}
    return params


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-cache shapes: ``{"layers": {"pos{j}": {"k", "v"}}}`` with each
    shape stacked over periods, plus the model dtype."""
    P, n_periods, pos_kinds, _ = period_info(cfg)
    layers = {}
    for j, kind in enumerate(pos_kinds):
        spec = attn_lib.cache_spec(_attn_cfg(cfg, kind), batch, seq_len)
        layers[f"pos{j}"] = {k: (n_periods,) + s for k, s in spec.items()}
    return {"layers": layers, "dtype": model_dtype(cfg)}


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


def _period_body(cfg: ModelConfig, P: int, pos_kinds, x, bps, on_kv=None):
    """One period of blocks over the whole sequence.  ``on_kv(j, cfg_attn,
    kv)`` receives each attention layer's full K/V, in layer order."""
    for j in range(P):
        bp, acfg = bps[f"pos{j}"], _attn_cfg(cfg, pos_kinds[j])
        h, kv = attn_lib.attention_prefill(bp["attn"], rmsnorm(bp["norm1"], x, cfg.norm_eps),
                                           cfg_attn=acfg)
        if on_kv is not None:
            on_kv(j, acfg, kv)
        x = x + h
        if cfg.d_ff > 0:
            x = x + mlp(bp["mlp"], rmsnorm(bp["norm2"], x, cfg.norm_eps),
                        act=cfg.mlp_act, gated=cfg.mlp_gated)
    return x


def _trunk(params, cfg: ModelConfig, x: torch.Tensor, on_kv=None,
           remat: str = "none") -> torch.Tensor:
    """Run every block over embedded inputs ``x`` (B, S, D) -> final-normed
    hidden states.  ``remat`` other than "none" recomputes each period in
    the backward (``torch.utils.checkpoint``); it takes no ``on_kv``."""
    require_supported(cfg)
    P, n_periods, pos_kinds, _ = period_info(cfg)
    for i in range(n_periods):
        bps = _period(params["blocks"], i)
        if remat == "none" or not _needs_grad(x, bps):
            x = _period_body(cfg, P, pos_kinds, x, bps, on_kv)
        else:
            # the blocks draw no random numbers: no RNG state to save, and
            # saving it would synchronize with the card every period
            x = torch.utils.checkpoint.checkpoint(
                _period_body, cfg, P, pos_kinds, x, bps, use_reentrant=False,
                preserve_rng_state=False)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _needs_grad(x: torch.Tensor, bps: dict) -> bool:
    """Whether autograd will record this period (else remat is moot)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(bps)))


def forward_train(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """Full-sequence forward -> (logits (B, S, V_pad) at every position,
    aux loss 0).  ``batch["inputs_embeds"]``, when present, replaces the
    token embedding (the grad-accumulation step passes it)."""
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat {remat!r}")
    x = batch["inputs_embeds"] if "inputs_embeds" in batch else \
        embed(params["embed"], batch["tokens"])
    x = _trunk(params, cfg, x, remat=remat)
    return unembed(params["embed"], x), torch.zeros((), device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: str = "dots"):
    """-> (loss, {"ce", "aux"}): mean next-token CE over the valid vocab
    (dense models carry no auxiliary loss)."""
    logits, aux = forward_train(params, cfg, batch, remat)
    ce = cross_entropy_loss(logits, batch["targets"], valid_vocab=cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int = 0):
    """Full-prompt forward -> (last-position logits (B, 1, V_pad), cache).

    ``batch["tokens"]`` is (B, S) int; the cache holds ``{"layers": ...,
    "pos": S}`` with ``pos`` a Python int."""
    P = period_info(cfg)[0]
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cache_len = max(cache_len, S + 1)
    caches = {f"pos{j}": {"k": [], "v": []} for j in range(P)}

    def keep(j, acfg, kv):
        ring = _ring_from_prefill(kv, acfg, S, cache_len)
        caches[f"pos{j}"]["k"].append(ring["k"])
        caches[f"pos{j}"]["v"].append(ring["v"])

    x = _trunk(params, cfg, embed(params["embed"], tokens), on_kv=keep)
    logits = unembed(params["embed"], x[:, -1:])
    layers = {name: {k: torch.stack(v) for k, v in c.items()} for name, c in caches.items()}
    return logits, {"layers": layers, "pos": int(S)}


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token (B, 1) int; cache from ``prefill``.  Returns (logits (B,1,V_pad),
    cache) — the cache's K/V are updated IN PLACE and ``pos`` advances."""
    require_supported(cfg)
    P, n_periods, pos_kinds, _ = period_info(cfg)
    pos = int(cache["pos"])
    x = embed(params["embed"], token)
    acfgs = [_attn_cfg(cfg, kind) for kind in pos_kinds]
    biases = [attn_lib.decode_bias(acfgs[j], cache["layers"][f"pos{j}"]["k"].shape[2],
                                   pos, x.device) for j in range(P)]
    for i in range(n_periods):
        bps = _period(params["blocks"], i)
        for j in range(P):
            bp = bps[f"pos{j}"]
            lc = cache["layers"][f"pos{j}"]
            h, _ = attn_lib.attention_decode(
                bp["attn"], rmsnorm(bp["norm1"], x, cfg.norm_eps),
                {"k": lc["k"][i], "v": lc["v"][i]}, pos, cfg_attn=acfgs[j],
                bias=biases[j])
            x = x + h
            if cfg.d_ff > 0:
                x = x + mlp(bp["mlp"], rmsnorm(bp["norm2"], x, cfg.norm_eps),
                            act=cfg.mlp_act, gated=cfg.mlp_gated)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x)
    cache["pos"] = pos + 1
    return logits, cache
