"""Plain PyTorch versions of kernels B1-B8 (the kernels' oracles).

The wrappers in ``quant8``/``bitpack``/``stream``/``nm_prune``/
``wanda_score`` take these for tensors on the CPU; the CUDA kernels are held
to them bit for bit on the card.

Scale rule: ``scale = absmax * f32(1/s)`` — a multiply by the f32-rounded
reciprocal, which is what the JAX package's Pallas kernels compute (XLA
rewrites their division by the constant ``s``).  ``repro/kernels/ref.py``
writes ``absmax / s``, which differs by one ulp on a few rows; the port
follows the kernels, because ``qsgd_kernel`` and the ``quant`` codec run
through them.  ``x / scale`` is a correctly rounded division, then
``floor(y + u)`` in f32, then the clip.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def levels(bits: int) -> int:
    """Quantization levels s = 2^(bits-1) - 1."""
    return 2 ** (bits - 1) - 1


def inv_levels(bits: int) -> float:
    """f32(1/s) as a Python float (exact in f32, so casting it back loses
    nothing)."""
    return float(np.float32(1.0) / np.float32(levels(bits)))


def _quant(x2d: torch.Tensor, noise2d: torch.Tensor, bits: int):
    """-> (q as f32 in [-s, s], scale (rows, 1) f32)."""
    s = levels(bits)
    x = x2d.float()
    scale = x.abs().amax(dim=1, keepdim=True) * x.new_tensor(inv_levels(bits))
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = (x / scale).add_(noise2d).floor_().clamp_(-s, s)
    return q, scale


def quant_dequant_ref(x2d: torch.Tensor, noise2d: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """B1: blockwise absmax quantize-dequantize with stochastic rounding."""
    q, scale = _quant(x2d, noise2d, bits)
    return q.mul_(scale).to(x2d.dtype)


def quant_pack_ref(x2d: torch.Tensor, noise2d: torch.Tensor, bits: int = 8):
    """B2: the same quantization emitted as wire planes (int8 q, f32 scales)."""
    q, scale = _quant(x2d, noise2d, bits)
    return q.to(torch.int8), scale


def unpack_dequant_ref(q2d: torch.Tensor, scales: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """B3: ``q * scale`` back to dense."""
    return q2d.float().mul_(scales).to(out_dtype)


def stream_quant_pack_ref(x2d: torch.Tensor, noise2d: torch.Tensor,
                          tile_rows: int = 8):
    """B6: B2's 8-bit planes computed tile by tile (port of
    ``repro/kernels/ref.py:stream_quant_pack_ref``, under the scale rule
    above).  Quantization blocks run along axis 1, so tiling the rows cannot
    change a bit; a large ``tile_rows`` bounds the temporaries (the last tile
    may be short)."""
    tiles = [quant_pack_ref(x2d[r:r + tile_rows], noise2d[r:r + tile_rows])
             for r in range(0, x2d.shape[0], tile_rows)]
    if not tiles:
        return quant_pack_ref(x2d, noise2d)
    return torch.cat([q for q, _ in tiles]), torch.cat([s for _, s in tiles])


# ---------------------------------------------------------------------------
# B4/B5: presence-mask bit packing (port of repro/kernels/ref.py:19-30)
# ---------------------------------------------------------------------------
def pack_mask_ref(mask2d: torch.Tensor) -> torch.Tensor:
    """B4: (32, C) mask, one byte per coordinate (nonzero = set) -> (1, C)
    int32 words holding the uint32 bits: bit j of word c is ``mask[j, c]``.
    One pass per bit row keeps the temporaries one row wide."""
    words = torch.zeros(mask2d.shape[1], dtype=torch.int32, device=mask2d.device)
    for j in range(mask2d.shape[0]):
        words |= mask2d[j].ne(0).to(torch.int32) << j
    return words.reshape(1, -1)


def unpack_mask_ref(words2d: torch.Tensor) -> torch.Tensor:
    """B5: (1, C) int32 words -> (32, C) uint8 mask of 0/1 (the Pallas kernel
    emits uint32 of the same values)."""
    words = words2d.reshape(-1)
    out = torch.empty((32, words.numel()), dtype=torch.uint8, device=words.device)
    for j in range(32):
        out[j] = (words >> j).bitwise_and_(1).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# B7/B8: pruning (port of repro/kernels/ref.py:66-100)
# ---------------------------------------------------------------------------
def nm_prune_ref(w: torch.Tensor, scores: torch.Tensor, n: int = 2, m: int = 4):
    """B7: keep the n best scores of every group of m along d_in.

    ``rank_i = #{k: s_k > s_i} + #{k < i: s_k == s_i}`` (compare-count with a
    first-index tie-break, so exactly n survive even among equal scores);
    returns ``(w * keep, keep)`` with ``keep`` in ``w``'s dtype."""
    d_in, d_out = w.shape
    g = scores.float().reshape(d_in // m, m, d_out)
    gi, gk = g[:, :, None, :], g[:, None, :, :]          # element i vs k
    idx = torch.arange(m, device=w.device)
    earlier = (idx[None, :] < idx[:, None])[None, :, :, None]   # k < i
    rank = (gk > gi).sum(2) + ((gk == gi) & earlier).sum(2)
    keep = (rank < n).to(w.dtype).reshape(d_in, d_out)
    return w * keep, keep


def _as_divisor(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar normalizer as a (1, 1) f32 tensor on ``like``'s device: a
    tensor divisor is divided elementwise on every device (a Python scalar
    may become a multiply by its reciprocal on the card)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(1, 1)


def wanda_scores_ref(w, xnorm, mode="wanda", alpha=0.5, beta=0.5, rowsum=None,
                     colsum=None, ynorm=None, mu_in=1.0, mu_out=1.0):
    """The B8 score of every weight, in the Pallas kernel's order:

      wanda     |w| * xn
      ria       (|w| / rowsum + |w| / colsum) * xn^alpha
      symwanda  ((beta |w|) xn) / mu_in + (((1 - beta) |w|) yn) / mu_out

    RIA's sums default to those of ``w`` (``repro/kernels/ref.py``'s form);
    ``ops.prune_scored`` passes them, padded."""
    aw = w.float().abs()
    if mode == "wanda":
        return aw * xnorm[:, None]
    if mode == "ria":
        rowsum = aw.sum(1) if rowsum is None else rowsum
        colsum = aw.sum(0) if colsum is None else colsum
        return (aw / rowsum[:, None] + aw / colsum[None, :]) * xnorm.pow(alpha)[:, None]
    if mode == "symwanda":
        return (beta * aw * xnorm[:, None] / _as_divisor(mu_in, aw)
                + (1.0 - beta) * aw * ynorm[None, :] / _as_divisor(mu_out, aw))
    raise ValueError(mode)


def wanda_prune_ref(w, xnorm, tau, mode="wanda", alpha=0.5, beta=0.5, rowsum=None,
                    colsum=None, ynorm=None, mu_in=1.0, mu_out=1.0, k=None, rows=None,
                    cols=None):
    """B8: keep ``s_ij >= tau_j``; returns ``(w * keep, keep)``, ``keep`` in
    ``w``'s dtype (a product, not a select: ``-w * 0`` is ``-0.0``).

    ``tau=None`` selects: ``tau_j`` is the k-th largest score of column j <
    cols over rows < rows (both default to w's shape) as ``torch.topk``
    gives it, NaN ranked above everything, and +inf past cols; the result
    is ``(w * keep, keep, tau)``."""
    s = wanda_scores_ref(w, xnorm, mode, alpha, beta, rowsum, colsum, ynorm,
                         mu_in, mu_out)
    selecting = tau is None
    if selecting:
        rows = w.shape[0] if rows is None else rows
        cols = w.shape[1] if cols is None else cols
        tau = s.new_full((s.shape[1],), math.inf)
        tau[:cols] = torch.topk(s[:rows, :cols].T, k).values[:, -1]
    keep = (s >= tau[None, :]).to(w.dtype)
    return (w * keep, keep, tau) if selecting else (w * keep, keep)
