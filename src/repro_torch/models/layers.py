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

from repro_torch.sharding.layout import AnyDTensor, shard_start


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


def row_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean(-1, keepdim=True)``.  On a DTensor whose last dim is
    sharded: a sum whose partials are reduced on every rank, then divided
    (so the rows keep their layout, instead of DTensor reduce-scattering
    the statistic over the sequence; an average's partials have no
    gradient rule)."""
    if not isinstance(t, AnyDTensor):
        return t.mean(-1, keepdim=True)
    from torch.distributed.tensor import Replicate
    s = t.sum(-1, keepdim=True)
    s = s.redistribute(s.device_mesh, [Replicate() if p.is_partial() else p
                                       for p in s.placements])
    return s / t.shape[-1]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = row_mean(x32.square())
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free L2 norm over the last dim (QK-norm)."""
    x32 = x.float()
    return (x32 * torch.rsqrt(row_mean(x32.square()) + eps)).to(x.dtype)


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


def along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for an op along ``dim`` (a pad, a roll) that keeps every
    other dim as it is: a DTensor runs it on its local shards with ``dim``
    whole, so no sharding strategy is asked of the op."""
    if not isinstance(x, AnyDTensor):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if p.is_partial() or p.is_shard(dim) else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def features_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last (feature) dim whole on every rank: a DTensor's
    shards of it gathered (and partial sums reduced) before a
    column-parallel matmul, as Megatron's tensor parallelism does; a plain
    tensor as it is."""
    if not isinstance(x, AnyDTensor):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(x.ndim - 1)
                                          or p.is_partial() else p for p in x.placements])


class _WholeGrad(torch.autograd.Function):
    """The identity; its backward gathers the gradient's feature dim."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return features_whole(g)


def whole_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``; on a DTensor, its gradient comes back with the feature dim
    whole (gathered) on every rank."""
    return _WholeGrad.apply(x) if isinstance(x, AnyDTensor) else x


def residual_add(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``.  On DTensors, where ``h`` is a partial sum over a mesh dim
    (a row-parallel projection's output), its sums are first reduced to
    ``x``'s placement on that dim (all-reduced where ``x`` is replicated,
    reduce-scattered where it is sharded); ``x`` is never redistributed.
    Stated here, not left to DTensor's choice of strategy, which differs
    between torch versions: 2.11 may turn a sharded ``x`` into a partial
    sum, a redistribution it does not support."""
    if not isinstance(h, AnyDTensor) or not any(p.is_partial() for p in h.placements):
        return x + h
    to = [xp if hp.is_partial() else hp for xp, hp in zip(x.placements, h.placements)]
    return x + h.redistribute(h.device_mesh, to)


def project_out(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for an output projection (row-parallel under tensor
    parallelism).  On DTensors its gradient arrives with the feature dim
    whole, so the backward's products keep the hidden dim sharded (DTensor
    would otherwise form the whole hidden dim's gradient as a partial sum
    on every rank)."""
    return whole_grad(h @ w)


def mlp(params: dict, x: torch.Tensor, act: str = "silu", gated: bool = True) -> torch.Tensor:
    x = features_whole(x)
    h = x @ params["w_in"]
    if gated:
        if act not in ("silu", "gelu"):
            raise ValueError(act)
        h = _act(x @ params["w_gate"], act) * h
    else:
        h = _act(h, act)
    return project_out(h, params["w_out"])


def init_embed(gen, vocab: int, d_model: int, dtype, device, tie: bool) -> dict:
    p = {"tok": _dense_init(gen, (vocab, d_model), dtype, device, scale=0.02)}
    if not tie:
        p["unembed"] = _dense_init(gen, (d_model, vocab), dtype, device, scale=0.02)
    return p


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(params["tok"], AnyDTensor):
        return _sharded_embed(params["tok"], tokens)
    return params["tok"][tokens]


def _sharded_embed(tok, tokens):
    """``embed`` of a DTensor table: each rank looks its own tokens (the
    batch sharded as the tokens are) up in its own table shard (the
    feature dim sharded as the table's; the vocab whole), so the lookup
    needs no sharding strategy for an index op over nested batch shards.
    The table's gradient is a partial sum over the ranks of the token
    shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tok.device_mesh
    ipl = ([Shard(0) if p.is_shard(0) else Replicate() for p in tokens.placements]
           if isinstance(tokens, AnyDTensor) else [Replicate()] * mesh.ndim)
    tpl = [Shard(1) if p.is_shard(1) and not ip.is_shard() else Replicate()
           for p, ip in zip(tok.placements, ipl)]
    out = [Shard(0) if ip.is_shard() else Shard(2) if tp.is_shard() else Replicate()
           for ip, tp in zip(ipl, tpl)]
    grad = [Partial() if ip.is_shard() else tp for ip, tp in zip(ipl, tpl)]
    return local_map(lambda t, i: t[i], out_placements=out, in_placements=(tpl, ipl),
                     in_grad_placements=(grad, ipl), device_mesh=mesh,
                     redistribute_inputs=True)(tok, tokens)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits.  On DTensors the (D, V) weight is first laid out over the
    vocab where the rules shard the tied table's feature dim, and ``x``'s
    feature dim is gathered, so the logits come out vocab-sharded and
    neither they nor their gradient are ever gathered over the vocab on a
    rank."""
    w = params["unembed"] if "unembed" in params else params["tok"].T
    if isinstance(w, AnyDTensor):
        from torch.distributed.tensor import Replicate, Shard
        V, mesh = w.shape[1], w.device_mesh
        pl = [Shard(1) if p.is_shard(0) and V % mesh.size(i) == 0
              else Replicate() if p.is_shard(0) else p for i, p in enumerate(w.placements)]
        w = w.redistribute(mesh, pl)
        x = features_whole(x)
    return x @ w


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, ignore: int = -1,
                       valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE in f32.  logits (..., V), targets (...,) int;
    ``valid_vocab`` masks padded vocab rows out of the partition function."""
    logits = logits.float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        dead = torch.arange(logits.shape[-1], device=logits.device) >= valid_vocab
        logits = logits.masked_fill(dead, -1e30)
    mask = (targets != ignore).float()
    # an ignored target may be out of range: gather at 0, masked out below
    idx = torch.where(targets != ignore, targets, torch.zeros_like(targets))
    if isinstance(logits, AnyDTensor):
        logz, gold = _sharded_logz_gold(logits, idx)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, idx[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def _sharded_logz_gold(logits, idx):
    """(logsumexp over the vocab, the gold logit) of a DTensor whose vocab
    dim may be sharded: the max and the sum reduce across ranks as (B, S)
    partials, and each rank gathers the gold logits its vocab shard holds
    (zero elsewhere, a partial sum), so no rank gathers the whole vocab."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    idx_pl = [Replicate() if p.is_shard(vdim) else p for p in pl]
    # the (B, S, 1) reductions whole over the vocab's mesh dims (DTensor
    # would otherwise reduce-scatter them over the batch, and their
    # gradients would then reshard the vocab-sharded logits)
    m = logits.detach().amax(-1, keepdim=True).redistribute(mesh, idx_pl)
    se = torch.exp(logits - m).sum(-1, keepdim=True).redistribute(mesh, idx_pl)
    logz = (m + torch.log(se))[..., 0]
    start = shard_start(mesh, pl, vdim, logits.shape[-1])
    out_pl = [Partial() if p.is_shard(vdim) else p for p in pl]

    def local(lg, ix):
        loc = ix.long() - start
        ok = (loc >= 0) & (loc < lg.shape[-1])
        g = lg.gather(-1, torch.where(ok, loc, torch.zeros_like(loc))[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros_like(g))

    gold = local_map(local, out_placements=out_pl, in_placements=(pl, idx_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, idx)
    return logz, gold.redistribute(mesh, idx_pl)
