"""B1: fused blockwise absmax int-s quantize + dequantize.

Port of ``repro/kernels/quant8.py:quant_dequant_2d``: the compute hot spot
of the ``qsgd_kernel`` compressor.  The flat tensor is viewed as
``(rows, QBLOCK)``, one scale per row; stochastic rounding takes its uniform
noise in [0, 1) as an input.  CUDA tensors run the hand-written kernel in
``csrc/quant.cu``; CPU tensors run the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

TILE_ROWS = 8
QBLOCK = 512  # quantization block size


def check_tiles(x2d: torch.Tensor, noise2d: torch.Tensor) -> None:
    rows = x2d.shape[0] if x2d.dim() == 2 else -1
    if x2d.dim() != 2 or x2d.shape[1] != QBLOCK or rows % TILE_ROWS:
        raise ValueError(f"expected (rows, {QBLOCK}) with rows % "
                         f"{TILE_ROWS} == 0, got {tuple(x2d.shape)}")
    build.check_tensor(x2d, "x2d", torch.float32, (rows, QBLOCK))
    build.check_tensor(noise2d, "noise2d", torch.float32, (rows, QBLOCK),
                       x2d.device)


def quant_dequant_2d(x2d: torch.Tensor, noise2d: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """x2d, noise2d: (rows, QBLOCK) f32, rows % TILE_ROWS == 0 -> f32.

    A CPU tensor runs the plain version, a card tensor the kernel.  A fake
    tensor (``FakeTensorMode``: the dry-run's stand-in for a card tensor)
    goes through the ``repro::quant_dequant_2d`` op, whose registered fake
    gives the output's shape and allocation; the card path launches
    directly, without the op's dispatch."""
    check_tiles(x2d, noise2d)
    if build.is_fake(x2d):
        return _quant_dequant_op(x2d, noise2d, bits)
    if x2d.device.type == "cpu":
        return ref.quant_dequant_ref(x2d, noise2d, bits)
    build.require_cuda(x2d)
    return _launch(x2d, noise2d, bits)


def _launch(x2d: torch.Tensor, noise2d: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.empty_like(x2d)
    build.launch("repro_quant_dequant_2d", x2d.device, x2d, noise2d, out,
                 x2d.shape[0], ref.levels(bits))
    quant_dequant_2d.launches += 1
    return out


@torch.library.custom_op("repro::quant_dequant_2d", mutates_args=(), device_types="cuda")
def _quant_dequant_op(x2d: torch.Tensor, noise2d: torch.Tensor, bits: int) -> torch.Tensor:
    return _launch(x2d, noise2d, bits)


@_quant_dequant_op.register_fake
def _(x2d, noise2d, bits):
    return torch.empty_like(x2d)


quant_dequant_2d.launches = 0
