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


def _attend(q, k, v, bias) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v in f32 over the whole key axis,
    decode's one query against the cache; q (B,Sq,H,hd), k/v (B,Sk,KV,hd),
    bias broadcastable to (Sq, Sk).  -> (B, Sq, H*hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Sq, KV, H // KV, hd)
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


def _layout(q, k, v, plan: _Plan):
    """-> (qf (B, KV, nq*bq, G, hd) f32 scaled by 1/sqrt(hd), kf and vf
    (B, KV, nk*bk, hd) f32), zero-padded to whole tiles."""
    qf = _q_rows(q.float() * (1.0 / math.sqrt(q.shape[-1])), plan, k.shape[2])
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
    in f32; its transients are one tile's scores and their gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, chunk, q_offset, block_q, block_k):
        plan = _plan(q.shape[1], k.shape[1], kind, window, chunk, q_offset, block_q,
                     block_k)
        tiles = _Tiles(plan, kind, window, chunk, q_offset, q.device)
        qf, kf, vf = _layout(q, k, v, plan)
        out, m, l = _flash_forward(qf, kf, vf, tiles)
        del qf, kf, vf
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.tiles = tiles
        B, Sq, H, hd = q.shape
        return out.permute(0, 2, 1, 3, 4)[:, :Sq].reshape(B, Sq, H, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m_all, l_all = ctx.saved_tensors
        tiles = ctx.tiles
        p = tiles.plan
        B, Sq, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        qf, kf, vf = _layout(q, k, v, p)
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
        dq = dq.mul_(1.0 / math.sqrt(hd)).permute(0, 2, 1, 3, 4)[:, :Sq]
        dk = dk.permute(0, 2, 1, 3)[:, :p.Sk]
        dv = dv.permute(0, 2, 1, 3)[:, :p.Sk]
        return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def _flash_attention(q, k, v, kind: str, window: int, chunk: int,
                     q_offset: int = 0, block_q: Optional[int] = None,
                     block_k: Optional[int] = None) -> torch.Tensor:
    """2D-tiled (flash-style) softmax attention. q (B,Sq,H,hd); k,v
    (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype (port of the reference's
    ``_flash_attention``, ``repro/models/attention.py:86``).

    q tiles of ``block_q`` rows (default ``BLOCK_Q``), each against kv
    blocks of ``block_k`` keys (default ``BLOCK_K``) with a running (max,
    denom, accum) per query in f32; query i sits at position q_offset + i,
    key j at position j; ragged lengths are zero-padded to whole tiles and
    padded keys masked.  Transient memory is one (B, bq, H, bk) f32 score
    tile; the backward (``_FlashAttention``) keeps O(S) per layer."""
    return _FlashAttention.apply(q, k, v, kind, window, chunk, q_offset, block_q, block_k)


def attention_prefill(params, x, *, cfg_attn: dict):
    """Causal attention over the whole prompt -> (output, cache{k, v}); the
    training forward too (under autograd, through the tiled backward)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg_attn["num_heads"], cfg_attn["num_kv_heads"],
                           cfg_attn["head_dim"], cfg_attn["qk_norm"], cfg_attn["use_rope"],
                           positions, cfg_attn["rope_theta"])
    out = _flash_attention(q, k, v, cfg_attn["kind"], cfg_attn["window"], cfg_attn["chunk"])
    out = out.reshape(B, S, -1) @ params["wo"]
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
