"""Wire-format packing kernels B2-B5 (port of ``repro/kernels/bitpack.py``).

B2/B3 (``quant_pack_2d``/``unpack_dequant_2d``): B2 emits what goes on the
wire — an int8 plane and one f32 scale per row — with the same arithmetic as
B1, so ``q * scale`` reproduces B1's dequantized carrier bit for bit; B3
computes that product.  Kernels in ``csrc/quant.cu``.

B4/B5 (``pack_mask_2d``/``unpack_mask_2d``): a (32, C) presence mask <->
C 32-bit words, bit j of word c = ``mask[j, c]`` (the stride-W order of
``ops.pack_bits``).  The mask is one byte per coordinate (``bool`` or
``uint8``), not the JAX kernel's uint32: the values are equal, and at the
main path's 1.83e9 coordinates the mask takes 1.83 GB instead of 7.3 GB.
Words are ``int32`` tensors holding the uint32 bits (``.numpy().view(
np.uint32)`` gives the wire plane).  Kernels in ``csrc/bitmask.cu``.

CUDA tensors run the kernels; CPU tensors run the plain versions in
``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.quant8 import QBLOCK, TILE_ROWS, check_tiles

PACK_BITS = 32      # mask bits per word


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


def pack_mask_2d(mask2d: torch.Tensor) -> torch.Tensor:
    """(32, C) bool/uint8 mask -> (1, C) int32 words (uint32 bits)."""
    if mask2d.dim() != 2 or mask2d.shape[0] != PACK_BITS:
        raise ValueError(f"expected ({PACK_BITS}, C), got {tuple(mask2d.shape)}")
    if mask2d.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask2d: dtype {mask2d.dtype}, expected bool or uint8")
    build.check_tensor(mask2d, "mask2d", mask2d.dtype, tuple(mask2d.shape), align=1)
    if mask2d.device.type == "cpu":
        return ref.pack_mask_ref(mask2d)
    build.require_cuda(mask2d)
    c = mask2d.shape[1]
    words = torch.empty((1, c), dtype=torch.int32, device=mask2d.device)
    if c:
        build.launch("repro_pack_mask_2d", mask2d.device, mask2d, words, c)
        pack_mask_2d.launches += 1
    return words


pack_mask_2d.launches = 0


def unpack_mask_2d(words2d: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_mask_2d: (1, C) int32 words -> (32, C) uint8 0/1."""
    if words2d.dim() != 2 or words2d.shape[0] != 1:
        raise ValueError(f"expected (1, C), got {tuple(words2d.shape)}")
    build.check_tensor(words2d, "words2d", torch.int32, tuple(words2d.shape), align=4)
    if words2d.device.type == "cpu":
        return ref.unpack_mask_ref(words2d)
    build.require_cuda(words2d)
    c = words2d.shape[1]
    mask = torch.empty((PACK_BITS, c), dtype=torch.uint8, device=words2d.device)
    if c:
        build.launch("repro_unpack_mask_2d", words2d.device, words2d, mask, c)
        unpack_mask_2d.launches += 1
    return mask


unpack_mask_2d.launches = 0
