"""Plain PyTorch versions of kernels B1-B3 (the kernels' oracles).

The wrappers in ``quant8``/``bitpack`` take these for tensors on the CPU;
the CUDA kernels are held to them bit for bit on the card.

Scale rule: ``scale = absmax * f32(1/s)`` — a multiply by the f32-rounded
reciprocal, which is what the JAX package's Pallas kernels compute (XLA
rewrites their division by the constant ``s``).  ``repro/kernels/ref.py``
writes ``absmax / s``, which differs by one ulp on a few rows; the port
follows the kernels, because ``qsgd_kernel`` and the ``quant`` codec run
through them.  ``x / scale`` is a correctly rounded division, then
``floor(y + u)`` in f32, then the clip.
"""
from __future__ import annotations

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
