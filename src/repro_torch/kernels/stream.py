"""B6: quantize-pack through a double-buffered streaming ring.

Port of ``repro/kernels/stream.py:stream_quant_pack_2d``: B2's wire planes
(int8 q, one f32 scale per row), bit for bit, with the kernel owning the
data movement — on Hopper a two-stage shared-memory ring filled by
``cp.async`` while the previous tile computes (``csrc/quant.cu``).  CUDA
tensors run the kernel; CPU tensors run the plain version in ``ref.py``.
8-bit only: nothing in the JAX package calls its kernel at another width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.quant8 import QBLOCK, TILE_ROWS, check_tiles


def stream_quant_pack_2d(x2d: torch.Tensor, noise2d: torch.Tensor):
    """(rows, QBLOCK) f32 -> (int8 plane (rows, QBLOCK), f32 scales (rows, 1)),
    equal to ``bitpack.quant_pack_2d``'s."""
    check_tiles(x2d, noise2d)
    if x2d.device.type == "cpu":
        return ref.stream_quant_pack_ref(x2d, noise2d, tile_rows=TILE_ROWS)
    build.require_cuda(x2d)
    rows = x2d.shape[0]
    q = torch.empty((rows, QBLOCK), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    if rows:
        build.launch("repro_stream_quant_pack_2d", x2d.device, x2d, noise2d, q,
                     scales, rows, ref.levels(8))
        stream_quant_pack_2d.launches += 1
    return q, scales


stream_quant_pack_2d.launches = 0
