"""B2/B3: fused quantize-pack to the wire planes, and its inverse.

Ports of ``repro/kernels/bitpack.py:quant_pack_2d`` and
``unpack_dequant_2d``.  B2 emits what goes on the wire — an int8 plane and
one f32 scale per row — with the same arithmetic as B1, so ``q * scale``
reproduces B1's dequantized carrier bit for bit; B3 computes that product.
CUDA tensors run the kernels in ``csrc/quant.cu``; CPU tensors run the plain
versions in ``ref.py``.  The mask kernels of the same JAX module (B4/B5)
belong to a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.quant8 import QBLOCK, TILE_ROWS, check_tiles


def quant_pack_2d(x2d: torch.Tensor, noise2d: torch.Tensor, bits: int = 8):
    """(rows, QBLOCK) f32 -> (int8 plane (rows, QBLOCK), f32 scales (rows, 1))."""
    check_tiles(x2d, noise2d)
    if x2d.device.type == "cpu":
        return ref.quant_pack_ref(x2d, noise2d, bits)
    build.require_cuda(x2d)
    rows = x2d.shape[0]
    q = torch.empty((rows, QBLOCK), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    build.launch("repro_quant_pack_2d", x2d.device, x2d, noise2d, q, scales,
                 rows, ref.levels(bits))
    quant_pack_2d.launches += 1
    return q, scales


quant_pack_2d.launches = 0


def unpack_dequant_2d(q2d: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of quant_pack_2d: int8 (rows, QBLOCK) + f32 (rows, 1) -> f32."""
    rows = q2d.shape[0] if q2d.dim() == 2 else -1
    if q2d.dim() != 2 or q2d.shape[1] != QBLOCK or rows % TILE_ROWS:
        raise ValueError(f"expected (rows, {QBLOCK}) with rows % "
                         f"{TILE_ROWS} == 0, got {tuple(q2d.shape)}")
    build.check_tensor(q2d, "q2d", torch.int8, (rows, QBLOCK), align=4)
    build.check_tensor(scales, "scales", torch.float32, (rows, 1), q2d.device,
                       align=4)
    if q2d.device.type == "cpu":
        return ref.unpack_dequant_ref(q2d, scales)
    build.require_cuda(q2d)
    out = torch.empty((rows, QBLOCK), dtype=torch.float32, device=q2d.device)
    build.launch("repro_unpack_dequant_2d", q2d.device, q2d, scales, out,
                 rows)
    unpack_dequant_2d.launches += 1
    return out


unpack_dequant_2d.launches = 0
