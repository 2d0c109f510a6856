"""GQA attention with global / sliding-window / chunked-local variants
(port of ``repro/models/attention.py``).

Prefill, training and the non-causal encoder / cross-attention run the
tiled (flash-style) softmax ``_flash_attention``: (BLOCK_Q x BLOCK_K) score
tiles with a running (max, denominator, accumulator) per query in f32, so
no (Sq, Sk) score matrix is ever built.  Its backward (``_FlashAttention``)
recomputes each score tile from q, k, v and the saved per-row max and
denominator, so what autograd keeps per layer is O(S), not O(S^2).
Decode runs one query token against the cache with ``_attend``: a ring
buffer of the window for SWA/chunked layers, a slot == position cache for
global ones.

The reference's attention is jnp under ``lax.scan`` (no Pallas kernel), and
so is this: plain torch, no kernel of its own.

Shapes: x (B, S, D); q heads H, kv heads KV (GQA groups G = H / KV).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_dense_init, apply_rope, features_whole, l2norm,
                                       project_out, whole_grad)
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import layout
from repro_torch.sharding.layout import AnyDTensor, shard_start

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
    x = features_whole(x)
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = split_heads(q, num_heads, head_dim)
    k = split_heads(k, num_kv_heads, head_dim)
    v = split_heads(v, num_kv_heads, head_dim)
    if qk_norm:
        q, k = l2norm(q), l2norm(k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, n, hd) -> (B, S, n*hd).  On a DTensor whose heads are not
    sharded the result's gradient comes back whole over its feature dim:
    the row-parallel product that follows would shard it across head
    boundaries, which the view back to heads cannot split."""
    out = t.reshape(t.shape[0], t.shape[1], -1)
    if isinstance(t, AnyDTensor) and not any(p.is_shard(2) for p in t.placements):
        out = whole_grad(out)
    return out


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd).  A DTensor whose last dim is sharded
    over more ranks than ``n`` heads divide over is gathered first."""
    if isinstance(t, AnyDTensor):
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        t = t.redistribute(mesh, [Replicate() if p.is_shard(t.ndim - 1) and n % mesh.size(i)
                                  else p for i, p in enumerate(t.placements)])
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _block_mask(q_idx, k_idx, kind: str, window: int, chunk: int) -> torch.Tensor:
    """(Sq, Sk) additive f32 mask for one (q-block, k-block) pair of
    indices: 0 where a query may see a key, NEG_INF elsewhere."""
    if kind == "full":      # non-causal (encoder / cross-attention)
        return torch.zeros((q_idx.shape[0], k_idx.shape[0]), dtype=torch.float32,
                           device=q_idx.device)
    ok = q_idx[:, None] >= k_idx[None, :]
    if kind == "attn_swa":
        ok = ok & (q_idx[:, None] - k_idx[None, :] < window)
    elif kind == "attn_chunk":
        ok = ok & ((q_idx[:, None] // chunk) == (k_idx[None, :] // chunk))
    zero = torch.zeros((), dtype=torch.float32, device=q_idx.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _scale(hd: int, scale: Optional[float]) -> float:
    """The softmax scale: ``scale`` where a config gives one, else
    1 / sqrt(hd)."""
    return scale or 1.0 / math.sqrt(hd)


def _attend(q, k, v, bias, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale q k^T + bias) v in f32 over the whole key axis,
    decode's one query against the cache; q (B,Sq,H,hd), k/v (B,Sk,KV,hd),
    bias broadcastable to (Sq, Sk); ``scale`` 1 / sqrt(hd) unless given.
    -> (B, Sq, H*hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * _scale(hd, scale)).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bnkh->bqkgn", qf, k.float())
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgn,bnkh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H * hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Tiled (flash) attention
# ---------------------------------------------------------------------------
# Tile sizes: (BLOCK_Q x BLOCK_K) transient score tiles.  Read at call time,
# so a costing harness can override them as module attributes.
BLOCK_Q = 512
BLOCK_K = 1024

# Banded flash: SWA / chunked layers visit only the KV blocks their window or
# chunk can reach, the diagonal block first and then downwards, as the
# reference's banded scan does.  Off by default, as there.
BANDED = False


class _Plan(NamedTuple):
    """One call's tiling: ``tiles[qi]`` lists the (kv block, class) pairs
    the q tile ``qi`` visits, in order; a class is "all" (every pair of the
    tile visible and no key padded: no mask is added, which is exact) or
    "some" (the mask and the pad mask are built and added)."""
    Sq: int
    Sk: int
    bq: int
    bk: int
    nq: int
    nk: int
    tiles: tuple


def _tile_class(qa: int, qb: int, ka: int, kb: int, kind: str, window: int,
                chunk: int) -> str:
    """Visibility of query positions [qa, qb] against key positions [ka, kb]
    under ``kind``: "all", "none" or "some"."""
    if kind == "full":
        return "all"
    if ka > qb:
        return "none"
    if kind == "attn_swa":
        if qa - kb >= window:
            return "none"
        return "all" if kb <= qa and qb - ka < window else "some"
    if kind == "attn_chunk":
        if kb // chunk < qa // chunk:
            return "none"
        return "all" if kb <= qa and ka // chunk == qb // chunk else "some"
    return "all" if kb <= qa else "some"


def _plan(Sq: int, Sk: int, kind: str, window: int, chunk: int, q_offset: int,
          block_q, block_k) -> _Plan:
    """The tiles of one call, from positions alone (no device value).

    Banded (``BANDED`` and an SWA / chunked kind): the reference's R blocks
    from ``qb_end`` downwards, negative ones dropped and the rest clipped to
    the last block, as its ``dynamic_index_in_dim`` does.  Otherwise the
    blocks in ascending order, less those whose every pair is masked: after
    the causal diagonal such a block's update is exactly the identity (p = 0,
    corr = 1), and before it what it adds to a row is wiped exactly (corr =
    exp(NEG_INF - m) = 0) once the row meets its own key, which every real
    row of the tile does when its position is below Sk (else those blocks
    are visited, as in the reference's full sweep)."""
    bq = min(block_q or BLOCK_Q, Sq)
    bk = min(block_k or BLOCK_K, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    banded = BANDED and kind in ("attn_swa", "attn_chunk")
    if banded:
        reach = window if kind == "attn_swa" else chunk
        R = min(nk, -(-reach // bk) + (2 if bq > 1 else 1))
    tiles = []
    for qi in range(nq):
        qa = q_offset + qi * bq
        qb = qa + bq - 1
        if banded:
            qb_end = qb // bk
            blocks = [min(qb_end - r, nk - 1) for r in range(R) if qb_end - r >= 0]
        else:
            blocks = range(nk)
        own_keys = q_offset + min(Sq, (qi + 1) * bq) - 1 < Sk
        visit = []
        for ki in blocks:
            ka = ki * bk
            cls = _tile_class(qa, qb, ka, ka + bk - 1, kind, window, chunk)
            if not banded and cls == "none" and (ka > qb or own_keys):
                continue
            visit.append((ki, "all" if cls == "all" and ka + bk <= Sk else "some"))
        tiles.append(tuple(visit))
    return _Plan(Sq, Sk, bq, bk, nq, nk, tuple(tiles))


def _layout(q, k, v, plan: _Plan, scale: Optional[float] = None):
    """-> (qf (B, KV, nq*bq, G, hd) f32 times the softmax scale, kf and vf
    (B, KV, nk*bk, hd) f32), zero-padded to whole tiles."""
    qf = _q_rows(q.float() * _scale(q.shape[-1], scale), plan, k.shape[2])
    pad_k = (0, 0, 0, 0, 0, plan.nk * plan.bk - plan.Sk)
    kf = F.pad(k.float(), pad_k).permute(0, 2, 1, 3)
    vf = F.pad(v.float(), pad_k).permute(0, 2, 1, 3)
    return qf, kf.contiguous(), vf.contiguous()


def _q_rows(x: torch.Tensor, plan: _Plan, KV: int) -> torch.Tensor:
    """(B, Sq, H, hd) -> (B, KV, nq*bq, G, hd) f32, zero-padded."""
    B, Sq, H, hd = x.shape
    x = F.pad(x.float(), (0, 0, 0, 0, 0, plan.nq * plan.bq - Sq))
    return x.reshape(B, plan.nq * plan.bq, KV, H // KV, hd).permute(0, 2, 1, 3, 4).contiguous()


class _Tiles:
    """Score tiles of one call: ``scores(qt, kf, qi, ki, cls)`` is the
    (B, KV, bq, G, bk) f32 tile of q tile ``qt`` against kv block ``ki``
    with its mask added (the mask plus the pad mask on padded keys, as the
    reference adds them)."""

    def __init__(self, plan: _Plan, kind: str, window: int, chunk: int, q_offset: int,
                 device):
        self.plan, self.kind, self.window, self.chunk = plan, kind, window, chunk
        self.q_offset, self.device = q_offset, device

    def bias(self, qi: int, ki: int, cls: str):
        p = self.plan
        if cls == "all":
            return None
        q_idx = self.q_offset + qi * p.bq + torch.arange(p.bq, device=self.device)
        k_idx = ki * p.bk + torch.arange(p.bk, device=self.device)
        mask = _block_mask(q_idx, k_idx, self.kind, self.window, self.chunk)
        if (ki + 1) * p.bk > p.Sk:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            mask = mask + torch.where(k_idx < p.Sk, zero, torch.full_like(zero, NEG_INF))
        return mask

    def scores(self, qt, kf, qi: int, ki: int, cls: str) -> torch.Tensor:
        p = self.plan
        B, KV = kf.shape[:2]
        kb = kf[:, :, ki * p.bk:(ki + 1) * p.bk]
        s = torch.matmul(qt, kb.transpose(-1, -2)).view(B, KV, p.bq, -1, p.bk)
        bias = self.bias(qi, ki, cls)
        if bias is not None:
            s.add_(bias[:, None, :])
        return s


def _flash_forward(qf, kf, vf, tiles: _Tiles):
    """-> (out (B, KV, nq*bq, G, hd) f32, row max m and denominator l
    (B, KV, nq*bq, G) f32): the online softmax over each q tile's visits."""
    p = tiles.plan
    B, KV, _, G, hd = qf.shape
    out = torch.empty_like(qf)
    m_all = qf.new_empty((B, KV, p.nq * p.bq, G))
    l_all = torch.empty_like(m_all)
    for qi, visit in enumerate(p.tiles):
        rows = slice(qi * p.bq, (qi + 1) * p.bq)
        qt = qf[:, :, rows].reshape(B, KV, p.bq * G, hd)
        m = qf.new_full((B, KV, p.bq, G), NEG_INF)
        l = qf.new_zeros((B, KV, p.bq, G))
        acc = qf.new_zeros((B, KV, p.bq, G, hd))
        for ki, cls in visit:
            s = tiles.scores(qt, kf, qi, ki, cls)
            m_new = torch.maximum(m, s.amax(-1))
            pt = s.sub_(m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l = l * corr + pt.sum(-1)
            vb = vf[:, :, ki * p.bk:(ki + 1) * p.bk]
            acc = acc * corr[..., None] + torch.matmul(
                pt.view(B, KV, p.bq * G, p.bk), vb).view(B, KV, p.bq, G, hd)
            m = m_new
            del s, pt
        out[:, :, rows] = acc / torch.clamp_min(l, 1e-30)[..., None]
        m_all[:, :, rows] = m
        l_all[:, :, rows] = l
    return out, m_all, l_all


class _FlashAttention(torch.autograd.Function):
    """The tiled attention with the flash backward.

    Saved for backward: q, k and v (the caller's tensors, not copies), the
    f32 output before its cast, and the per-row max and denominator:
    |q| + |k| + |v| + 4 B H hd nq bq + 8 B H nq bq bytes, O(S) per layer.
    The backward recomputes each visited score tile from them,
    p = exp(s - m) / max(l, 1e-30), and accumulates dv += p^T do,
    ds = p (do v^T - D) with D = rowsum(do * out), dq += ds k, dk += ds^T q
    in f32; its transients are one tile's scores and their gradient.

    Each call's forward and backward are one ``model/attn/forward`` /
    ``model/attn/backward`` span; the backward, and a remat recompute of the
    forward, run on autograd's thread."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, chunk, q_offset, block_q, block_k, scale):
        plan = _plan(q.shape[1], k.shape[1], kind, window, chunk, q_offset, block_q,
                     block_k)
        with obs_trace.span("model/attn/forward"):
            tiles = _Tiles(plan, kind, window, chunk, q_offset, q.device)
            qf, kf, vf = _layout(q, k, v, plan, scale)
            out, m, l = _flash_forward(qf, kf, vf, tiles)
            del qf, kf, vf
            ctx.save_for_backward(q, k, v, out, m, l)
            ctx.tiles, ctx.scale = tiles, scale
            B, Sq, H, hd = q.shape
            return out.permute(0, 2, 1, 3, 4)[:, :Sq].reshape(B, Sq, H, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m_all, l_all = ctx.saved_tensors
        tiles = ctx.tiles
        p = tiles.plan
        with obs_trace.span("model/attn/backward"):
            B, Sq, H, hd = q.shape
            KV = k.shape[2]
            G = H // KV
            qf, kf, vf = _layout(q, k, v, p, ctx.scale)
            do = _q_rows(dout, p, KV)
            D = (do * out).sum(-1)
            dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
            for qi, visit in enumerate(p.tiles):
                rows = slice(qi * p.bq, (qi + 1) * p.bq)
                qt = qf[:, :, rows].reshape(B, KV, p.bq * G, hd)
                dot = do[:, :, rows].reshape(B, KV, p.bq * G, hd)
                m = m_all[:, :, rows][..., None]
                l = torch.clamp_min(l_all[:, :, rows], 1e-30)[..., None]
                Dt = D[:, :, rows][..., None]
                dqt = torch.zeros_like(qt)
                for ki, cls in visit:
                    cols = slice(ki * p.bk, (ki + 1) * p.bk)
                    pt = tiles.scores(qt, kf, qi, ki, cls).sub_(m).exp_().div_(l)
                    p2 = pt.view(B, KV, p.bq * G, p.bk)
                    dv[:, :, cols] += torch.matmul(p2.transpose(-1, -2), dot)
                    dp = torch.matmul(dot, vf[:, :, cols].transpose(-1, -2))
                    ds = p2.mul_(dp.view(B, KV, p.bq, G, p.bk).sub_(Dt).view_as(p2))
                    del dp
                    dqt += torch.matmul(ds, kf[:, :, cols])
                    dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2), qt)
                    del pt, p2, ds
                dq[:, :, rows] = dqt.view(B, KV, p.bq, G, hd)
            dq = dq.mul_(_scale(hd, ctx.scale)).permute(0, 2, 1, 3, 4)[:, :Sq]
            dk = dk.permute(0, 2, 1, 3)[:, :p.Sk]
            dv = dv.permute(0, 2, 1, 3)[:, :p.Sk]
            return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                    None, None, None, None, None, None, None)


def _flash_attention(q, k, v, kind: str, window: int, chunk: int,
                     q_offset: int = 0, block_q: Optional[int] = None,
                     block_k: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """2D-tiled (flash-style) softmax attention. q (B,Sq,H,hd); k,v
    (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype (port of the reference's
    ``_flash_attention``, ``repro/models/attention.py:86``).

    q tiles of ``block_q`` rows (default ``BLOCK_Q``), each against kv
    blocks of ``block_k`` keys (default ``BLOCK_K``) with a running (max,
    denom, accum) per query in f32; query i sits at position q_offset + i,
    key j at position j; ragged lengths are zero-padded to whole tiles and
    padded keys masked.  Transient memory is one (B, bq, H, bk) f32 score
    tile; the backward (``_FlashAttention``) keeps O(S) per layer.  The
    scores are scaled by ``scale``, 1 / sqrt(hd) unless given.

    On DTensors (a launcher's mesh) the tile loop runs on each rank's local
    shards through ``local_map`` (``_sharded_flash``), as the reference's
    partitioned program does."""
    if isinstance(q, AnyDTensor):
        return _sharded_flash(q, k, v, kind, window, chunk, q_offset, block_q, block_k,
                              scale)
    return _FlashAttention.apply(q, k, v, kind, window, chunk, q_offset, block_q, block_k,
                                 scale)


def _sharded_flash(q, k, v, kind, window, chunk, q_offset, block_q, block_k, scale=None):
    """``_flash_attention`` of DTensors: batch sharded over the mesh's data
    axes and heads over the tensor-parallel axis wherever the dims divide
    (``sharding.layout``), the tiles of each rank's shards computed
    locally.  Where the q heads divide over that axis but the kv heads do
    not, k and v stay whole over it and each rank takes the kv head of each
    of its q heads (their gradients are then partial sums over it)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, _, H, hd = q.shape
    KV = k.shape[2]
    q_sh = layout.divides(H, layout.MODEL, mesh)
    kv_sh = layout.divides(KV, layout.MODEL, mesh)
    qpl = layout.local_placements(mesh, B, model_dim=2 if q_sh else None)
    pick = None
    if kv_sh or not q_sh:
        kvpl = kv_grad = layout.local_placements(mesh, B, model_dim=2 if kv_sh and q_sh
                                                 else None)
    else:
        kvpl = layout.local_placements(mesh, B)
        kv_grad = layout.local_placements(mesh, B, partial_model=True)
        h0 = shard_start(mesh, qpl, 2, H)
        pick = lambda n, dev: (torch.arange(h0, h0 + n, device=dev)  # noqa: E731
                               // (H // KV))

    def local(ql, kl, vl):
        if pick is not None:
            heads = pick(ql.shape[2], ql.device)
            kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
        return _FlashAttention.apply(ql, kl, vl, kind, window, chunk, q_offset, block_q,
                                     block_k, scale)

    return local_map(local, out_placements=qpl, in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _attention_causal(params, x, cfg_attn: dict, positions=None):
    """Causal attention over the whole sequence -> (output, k, v), the
    queries and keys rotated at ``positions`` (default ``arange(S)``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg_attn["num_heads"], cfg_attn["num_kv_heads"],
                           cfg_attn["head_dim"], cfg_attn["qk_norm"], cfg_attn["use_rope"],
                           positions, cfg_attn["rope_theta"])
    out = _flash_attention(q, k, v, cfg_attn["kind"], cfg_attn["window"], cfg_attn["chunk"],
                           scale=cfg_attn.get("scale"))
    return project_out(merge_heads(out), params["wo"]), k, v


def attention_train(params, x, *, cfg_attn: dict, positions=None):
    """cfg_attn keys: num_heads num_kv_heads head_dim kind window chunk
    qk_norm use_rope rope_theta (and ``scale``, the softmax scale, where a
    config gives one); ``positions`` (1 or B, S) rotate q and k
    (the masks stay on the sequence index, as the reference's)."""
    return _attention_causal(params, x, cfg_attn, positions)[0]


def attention_prefill(params, x, *, cfg_attn: dict):
    """Causal attention over the whole prompt -> (output, cache{k, v}); the
    training forward too (under autograd, through the tiled backward)."""
    out, k, v = _attention_causal(params, x, cfg_attn)
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
    if bias is None:
        bias = decode_bias(cfg_attn, Sc, pos, x.device)
    if isinstance(k, AnyDTensor):
        _write_slot(k, slot, k_new[:, 0])
        _write_slot(v, slot, v_new[:, 0])
        return _sharded_attend(q, k, v, bias, cfg_attn.get("scale")) @ params["wo"], cache
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    out = _attend(q, k, v, bias[None, :], cfg_attn.get("scale")) @ params["wo"]
    return out, cache


def _cache_placements(cache):
    """(the cache's placements with any partial resolved, a (B, ...) tensor's
    placements beside it: its batch sharding, the rest replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p.is_partial() else p for p in cache.placements]
    return pl, [Shard(0) if p.is_shard(0) else Replicate() for p in pl]


def _write_slot(cache, slot: int, new) -> None:
    """``cache[:, slot] = new`` on a DTensor cache (B, Sc, KV, hd) whose slot
    axis may be sharded: the rank that holds the slot writes it, in place."""
    from torch.distributed.tensor.experimental import local_map

    pl, bpl = _cache_placements(cache)
    start = shard_start(cache.device_mesh, pl, 1, cache.shape[1])

    def local(c, n):
        if start <= slot < start + c.shape[1]:
            c[:, slot - start] = n
        return c

    local_map(local, out_placements=pl, in_placements=(pl, bpl),
              device_mesh=cache.device_mesh, redistribute_inputs=True)(cache, new)


def _sharded_attend(q, k, v, bias, scale: Optional[float] = None) -> torch.Tensor:
    """``_attend`` of a DTensor cache whose slot axis may be sharded (the
    rules shard it over "model"), flash-decoding style: each rank scores its
    slots (its part of ``bias``), the per-row maxima meet in a max
    all-reduce, and the rescaled denominators and outputs in sum
    all-reduces; no rank gathers the cache.  -> (B, Sq, H*hd)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    kpl, qpl = _cache_placements(k)
    seq = [p.is_shard(1) for p in kpl]
    max_pl = [Partial("max") if s else p for s, p in zip(seq, qpl)]
    sum_pl = [Partial("sum") if s else p for s, p in zip(seq, qpl)]
    start = shard_start(mesh, kpl, 1, k.shape[1])
    B, Sq, H, hd = q.shape

    def scores(ql, kl, vl):
        KV = kl.shape[2]
        qf = (ql.float() * _scale(hd, scale)).reshape(ql.shape[0], Sq, KV, H // KV, hd)
        s = torch.einsum("bqkgh,bnkh->bqkgn", qf, kl.float())
        s = s + bias[start:start + kl.shape[1]][None, None, None, None, :]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        return m, p.sum(-1), torch.einsum("bqkgn,bnkh->bqkgh", p, vl.float())

    def rescale(m_l, m, l_l, o_l):
        corr = torch.exp(m_l - m)
        return l_l * corr, o_l * corr[..., None]

    m_l, l_l, o_l = local_map(scores, out_placements=(max_pl, sum_pl, sum_pl),
                              in_placements=(qpl, kpl, kpl), device_mesh=mesh,
                              redistribute_inputs=True)(q, k, v)
    m = m_l.redistribute(mesh, qpl)
    l_r, o_r = local_map(rescale, out_placements=(sum_pl, sum_pl),
                         in_placements=(max_pl, qpl, sum_pl, sum_pl),
                         device_mesh=mesh)(m_l, m, l_l, o_l)
    out = o_r.redistribute(mesh, qpl) / l_r.redistribute(mesh, qpl)[..., None]
    return out.reshape(B, Sq, H * hd).to(q.dtype)
