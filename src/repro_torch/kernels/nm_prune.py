"""B7: N:M structured prune by score.

Port of ``repro/kernels/nm_prune.py:nm_prune_2d``: the 2:4 backend of
``core/symwanda.mask_nm``.  In every group of m consecutive rows (along
d_in) of each output column, the n highest scores survive, ranked by
compare-count with a first-index tie-break.  CUDA tensors run the kernel in
``csrc/prune.cu``; CPU tensors run the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

TILE_R = 128
TILE_C = 128
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_weight(w: torch.Tensor) -> tuple:
    """Raise unless ``w`` is a contiguous (d_in, d_out) f32/bf16 matrix of
    whole (TILE_R, TILE_C) tiles; return its shape."""
    if w.dim() != 2 or w.shape[0] % TILE_R or w.shape[1] % TILE_C:
        raise ValueError(f"expected (d_in, d_out) with d_in % {TILE_R} == 0 and "
                         f"d_out % {TILE_C} == 0, got {tuple(w.shape)}")
    if w.dtype not in _SUFFIX:
        raise TypeError(f"w: dtype {w.dtype}, expected float32 or bfloat16")
    build.check_tensor(w, "w", w.dtype, w.shape, align=w.element_size())
    return tuple(w.shape)


def entry(name: str, w: torch.Tensor) -> str:
    """The C entry of kernel ``name`` for ``w``'s dtype."""
    return f"repro_{name}_{_SUFFIX[w.dtype]}"


def nm_prune_2d(w: torch.Tensor, scores: torch.Tensor, n: int = 2, m: int = 4):
    """w (d_in, d_out) f32/bf16, scores f32 of the same shape -> (w * mask,
    mask), mask in w's dtype."""
    d_in, d_out = check_weight(w)
    if m not in (1, 2, 4, 8) or not 1 <= n <= m:
        raise ValueError(f"n:m = {n}:{m}; need m in (1, 2, 4, 8), 1 <= n <= m")
    build.check_tensor(scores, "scores", torch.float32, (d_in, d_out), w.device,
                       align=4)
    if w.device.type == "cpu":
        return ref.nm_prune_ref(w, scores, n, m)
    build.require_cuda(w)
    out, mask = torch.empty_like(w), torch.empty_like(w)
    build.launch(entry("nm_prune_2d", w), w.device, w, scores, out, mask,
                 d_in, d_out, n, m)
    nm_prune_2d.launches += 1
    return out, mask


nm_prune_2d.launches = 0
