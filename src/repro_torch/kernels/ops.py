"""Public wrappers around the quantization kernels (port of
``repro/kernels/ops.py:59-133``).

They pad a flat tensor to whole ``(TILE_ROWS, QBLOCK)`` tiles and supply the
stochastic-rounding noise, then call B1/B2/B3.  The noise is either passed
in (``noise=``, shape ``(rows_pad, QBLOCK)``, f32 in [0, 1) — how the tests
inject the JAX package's draw) or drawn from an explicit ``generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitpack as _bp
from repro_torch.kernels import quant8 as _q8


def tile_rows(d: int) -> int:
    """Rows of the padded (rows_pad, QBLOCK) view of a d-element tensor."""
    rows = -(-d // _q8.QBLOCK)
    return -(-rows // _q8.TILE_ROWS) * _q8.TILE_ROWS


def _quant_tiles(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Shared shape plumbing of every quantize entry point: pad the flat
    tensor with zeros to whole tiles and take or draw the noise.  ONE
    definition on purpose — quantize_pack and quantize_dequantize are
    bit-identical only while they pad and draw identically.  When ``x``
    already fills whole tiles the padded view is ``x`` itself (no copy)."""
    flat = x.contiguous().reshape(-1)
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


def unpack_dequantize(q: torch.Tensor, scales: torch.Tensor,
                      d: int) -> torch.Tensor:
    """Inverse of quantize_pack: wire planes -> flat (d,) f32 tensor."""
    return _bp.unpack_dequant_2d(q, scales).reshape(-1)[:d]


def quantize_dequantize(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        bits: int = 8) -> torch.Tensor:
    """Blockwise absmax quantize-dequantize of an any-shape f32 tensor."""
    padded, noise, d = _quant_tiles(x, noise, generator)
    out = _q8.quant_dequant_2d(padded, noise, bits=bits)
    return out.reshape(-1)[:d].reshape(x.shape)


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
