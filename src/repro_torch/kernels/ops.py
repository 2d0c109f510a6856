"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

Mask bit packing (B4/B5): ``pack_bits``/``unpack_bits`` view a flat mask of
d coordinates as (32, W), W = ceil(d/32), so bit j of word w is
``mask[j*W + w]`` (the JAX package's stride-W order, which is the
``sparse_bitmap`` wire format).

Quantization (B1/B2/B3/B6): pad a flat tensor to whole ``(TILE_ROWS, QBLOCK)``
tiles and supply the stochastic-rounding noise.  The noise is either passed
in (``noise=``, shape ``(rows_pad, QBLOCK)``, f32 in [0, 1) — how the tests
inject the JAX package's draw) or drawn from an explicit ``generator``.

Pruning (B7/B8): ``prune_nm`` is the N:M backend of
``core/symwanda.mask_nm`` and ``prune_scored`` the fused backend of
``core/symwanda.prune``.  They pad a (d_in, d_out) weight to whole 128 x 128
tiles and compute the cheap statistics the kernels take (input norms,
RIA sums, symwanda normalizers) with torch, as the JAX package computes
them outside its Pallas kernels; B8 finds the per-output thresholds
itself.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import bitpack as _bp
from repro_torch.kernels import nm_prune as _nm
from repro_torch.kernels import quant8 as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import stream as _st
from repro_torch.kernels import wanda_score as _ws


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Flat bool/uint8 mask (d,) -> (ceil(d/32),) int32 words (uint32 bits)
    in the stride-W order.  The (32, W) view is the mask itself when d fills
    it (no copy); otherwise a zero-padded copy, so bits past d are 0."""
    flat = mask.contiguous().reshape(-1)
    d = flat.numel()
    w = -(-d // _bp.PACK_BITS)
    if d == _bp.PACK_BITS * w:
        m2d = flat.view(_bp.PACK_BITS, w)
    else:
        m2d = flat.new_zeros((_bp.PACK_BITS, w))
        m2d.view(-1)[:d] = flat
    return _bp.pack_mask_2d(m2d).reshape(-1)


def unpack_bits(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of pack_bits: (ceil(d/32),) int32 words -> (d,) uint8 0/1."""
    w = words.numel()
    if w != -(-d // _bp.PACK_BITS):
        raise ValueError(f"{w} words for d={d}, expected {-(-d // _bp.PACK_BITS)}")
    return _bp.unpack_mask_2d(words.contiguous().reshape(1, w)).reshape(-1)[:d]


def tile_rows(d: int) -> int:
    """Rows of the padded (rows_pad, QBLOCK) view of a d-element tensor."""
    rows = -(-d // _q8.QBLOCK)
    return -(-rows // _q8.TILE_ROWS) * _q8.TILE_ROWS


def _quant_tiles(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Shared shape plumbing of every quantize entry point: pad the flat
    tensor with zeros to whole tiles and take or draw the noise.  ONE
    definition on purpose — quantize_pack, stream_quantize_pack and
    quantize_dequantize are bit-identical only while they pad and draw
    identically.  When ``x`` already fills whole tiles the padded view is
    ``x`` itself (no copy).  The kernels compute in f32: another float dtype
    is widened first (exact for bf16 and f16), as the JAX kernels cast their
    tile."""
    flat = x.contiguous().reshape(-1).float()
    d = flat.numel()
    rows_pad = tile_rows(d)
    n = rows_pad * _q8.QBLOCK
    if n == d:
        padded = flat.view(rows_pad, _q8.QBLOCK)
    else:
        padded = flat.new_zeros((rows_pad, _q8.QBLOCK))
        padded.view(-1)[:d] = flat
    if noise is None:
        if generator is None:
            raise ValueError("stochastic rounding needs noise= or generator=")
        noise = torch.rand((rows_pad, _q8.QBLOCK), generator=generator,
                           dtype=torch.float32, device=x.device)
    elif tuple(noise.shape) != (rows_pad, _q8.QBLOCK):
        raise ValueError(f"noise shape {tuple(noise.shape)}, expected "
                         f"{(rows_pad, _q8.QBLOCK)}")
    else:
        noise = noise.to(device=x.device, dtype=torch.float32).contiguous()
    return padded, noise, d


def quantize_pack(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, bits: int = 8):
    """Any-shape f32 tensor -> (int8 plane (rows_pad, QBLOCK), scales
    (rows_pad, 1)).  ``q * scales`` reproduces quantize_dequantize's output
    bit for bit (same padding, same noise)."""
    padded, noise, _ = _quant_tiles(x, noise, generator)
    return _bp.quant_pack_2d(padded, noise, bits=bits)


def stream_quantize_pack(x: torch.Tensor, noise: torch.Tensor):
    """8-bit quantize_pack through kernel B6's double-buffered ring: the same
    padding, and the noise passed in, so the planes equal quantize_pack's
    bit for bit.

    B6 exists only as the counterpart of the JAX package's streaming kernel:
    no codec or user path calls it (``encode_stream`` packs through B2, as
    the JAX package's does), so only the tests and ``chip_smoke.py`` run it."""
    padded, noise, _ = _quant_tiles(x, noise)
    return _st.stream_quant_pack_2d(padded, noise)


def unpack_dequantize(q: torch.Tensor, scales: torch.Tensor,
                      d: int) -> torch.Tensor:
    """Inverse of quantize_pack: wire planes -> flat (d,) f32 tensor."""
    return _bp.unpack_dequant_2d(q, scales).reshape(-1)[:d]


def quantize_dequantize(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        bits: int = 8) -> torch.Tensor:
    """Blockwise absmax quantize-dequantize of an any-shape float tensor,
    computed in f32 and returned in ``x``'s dtype (the JAX kernel's
    ``out_shape``)."""
    padded, noise, d = _quant_tiles(x, noise, generator)
    out = _q8.quant_dequant_2d(padded, noise, bits=bits)
    return out.reshape(-1)[:d].reshape(x.shape).to(x.dtype)


def nibble_pack(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] -> two per byte, uint8 (4-bit transport)."""
    u = (q.reshape(-1).to(torch.int32) + 8).to(torch.uint8)
    if u.numel() % 2:
        u = torch.cat([u, u.new_zeros(1)])
    return u[0::2] | (u[1::2] << 4)


def nibble_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of nibble_pack -> int8 (n,) values in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n].to(torch.int8)


# ---------------------------------------------------------------------------
# N:M prune (B7) and fused wanda/ria/symwanda prune (B8)
# ---------------------------------------------------------------------------
def _pad2d(a: torch.Tensor, tr: int, tc: int, fill: float = 0.0):
    """-> (a padded with ``fill`` to whole (tr, tc) tiles, rows, cols); ``a``
    itself, made contiguous, when it already fills whole tiles."""
    r, c = a.shape
    rp, cp = -(-r // tr) * tr, -(-c // tc) * tc
    if (rp, cp) == (r, c):
        return a.contiguous(), r, c
    out = a.new_full((rp, cp), fill)
    out[:r, :c] = a
    return out, r, c


def _pad1d(v: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    v = v.float().contiguous()
    if v.numel() == n:
        return v
    out = v.new_full((n,), fill)
    out[:v.numel()] = v
    return out


def prune_nm(w: torch.Tensor, scores: torch.Tensor, n: int = 2, m: int = 4):
    """(d_in, d_out) N:M prune by score; returns (pruned, mask) in w's dtype."""
    wp, r, c = _pad2d(w, _nm.TILE_R, _nm.TILE_C)
    # padded score rows must never win: fill with -inf
    sp, _, _ = _pad2d(scores.float(), _nm.TILE_R, _nm.TILE_C, fill=-math.inf)
    out, mask = _nm.nm_prune_2d(wp, sp, n=n, m=m)
    return out[:r, :c], mask[:r, :c]


def input_norms(X: torch.Tensor) -> torch.Tensor:
    """Per-input-channel l2 norms of calibration activations (T, d_in) in f32."""
    return X.float().square().sum(0).sqrt()


def keep_count(d_in: int, sparsity: float) -> int:
    """k, the scores each output column keeps: round((1 - sparsity) d_in),
    at least 1 (Python's round, as the JAX ops layer)."""
    return max(1, int(round((1 - sparsity) * d_in)))


def _statistics(w: torch.Tensor, X: torch.Tensor, mode: str, alpha: float,
                beta: float) -> dict:
    """The unpadded statistics of a fused prune, as keyword arguments of
    ``wanda_prune_2d`` (without tau): input norms, RIA sums, symwanda's
    output norms and normalizers.  All stay on w's device (symwanda's
    ``mu_in`` / ``mu_out`` as 0-d f32 tensors): nothing is read back."""
    xnorm = input_norms(X)
    kw = dict(xnorm=xnorm, mode=mode, alpha=alpha, beta=beta)
    if mode == "ria":
        aw = w.float().abs()
        kw.update(rowsum=aw.sum(1), colsum=aw.sum(0))
    elif mode == "symwanda":
        ynorm = input_norms(X @ w)
        aw = w.float().abs()
        kw.update(ynorm=ynorm, mu_in=(aw * xnorm[:, None]).mean(),
                  mu_out=(aw * ynorm[None, :]).mean())
    elif mode != "wanda":
        raise ValueError(mode)
    return kw


def _padded(w: torch.Tensor, kw: dict):
    """-> (w padded to whole tiles, kw with padded statistics, (rows, cols)).
    Padding: xnorm 0, RIA sums 1, ynorm 0."""
    wp, r, c = _pad2d(w, _ws.TILE_R, _ws.TILE_C)
    rp, cp = wp.shape
    kw = dict(kw, xnorm=_pad1d(kw["xnorm"], rp, 0.0))
    if kw["mode"] == "ria":
        kw.update(rowsum=_pad1d(kw["rowsum"], rp, 1.0), colsum=_pad1d(kw["colsum"], cp, 1.0))
    elif kw["mode"] == "symwanda":
        kw.update(ynorm=_pad1d(kw["ynorm"], cp, 0.0))
    return wp, kw, (r, c)


def scored_args(w: torch.Tensor, X: torch.Tensor, mode: str = "wanda",
                sparsity: float = 0.5, alpha: float = 0.5, beta: float = 0.5):
    """The statistics and per-output thresholds of a fused prune ->
    (padded w, keyword arguments of ``wanda_prune_2d``, (rows, cols)).

    ``tau_j`` is the k-th largest score of column j (``keep_count``) from
    the plain version's full score matrix, as the JAX ops layer takes it;
    padded columns get tau = +inf.  This is B8's tau-given route, kept for
    the tests and checks that hold the selecting route to it."""
    kw = _statistics(w, X, mode, alpha, beta)
    scores = _ref.wanda_scores_ref(w, **kw)
    tau = torch.topk(scores.T, keep_count(w.shape[0], sparsity)).values[:, -1]
    del scores
    wp, kw, rc = _padded(w, kw)
    kw["tau"] = _pad1d(tau, wp.shape[1], math.inf)
    return wp, kw, rc


def prune_scored(w: torch.Tensor, X: torch.Tensor, mode: str = "wanda",
                 sparsity: float = 0.5, alpha: float = 0.5, beta: float = 0.5):
    """Fused score+mask prune of w (d_in, d_out) with calibration X (T, d_in):
    keep the top (1 - sparsity) of every output column.  Returns (pruned,
    mask) in w's dtype.

    The statistics come from torch; then one launch of B8 in its selecting
    mode finds each column's threshold and writes the mask, so no score
    matrix is built and no top-k is called on the card (on the CPU the plain
    version does both)."""
    wp, kw, (r, c) = _padded(w, _statistics(w, X, mode, alpha, beta))
    out, mask, _ = _ws.wanda_prune_2d(wp, tau=None, k=keep_count(r, sparsity),
                                      rows=r, cols=c, **kw)
    return out[:r, :c], mask[:r, :c]
