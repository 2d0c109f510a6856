"""B8: fused pruning score + per-output threshold mask.

Port of ``repro/kernels/wanda_score.py:wanda_prune_2d``: the fused backend of
``core/symwanda.prune``.  The kernel recomputes each weight's score from
O(d_in + d_out) statistics and keeps ``s_ij >= tau_j``.  ``ops.scored_args``
takes ``tau`` from the plain version's full f32 score matrix (a top-k per
column, as the JAX ops layer does), so on that path the fusion saves only the
mask pass, not the score matrix's trip to memory:

  wanda     s = |w| * xnorm_i
  ria       s = (|w| / rowsum_i + |w| / colsum_j) * xnorm_i^alpha
  symwanda  s = beta |w| xnorm_i / mu_in + (1 - beta) |w| ynorm_j / mu_out

CUDA tensors run the kernel in ``csrc/prune.cu``; CPU tensors run the plain
version in ``ref.py``.  The JAX kernel packs symwanda's two normalizers into
a (1, 128) row; here they are the scalars ``mu_in`` and ``mu_out``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.nm_prune import TILE_C, TILE_R, check_weight, entry

MODES = {"wanda": 0, "ria": 1, "symwanda": 2}   # the kernel's mode ids


def _vec(v, name: str, n: int, w: torch.Tensor) -> torch.Tensor:
    if v is None:
        raise ValueError(f"{name} is required in this mode")
    build.check_tensor(v, name, torch.float32, (n,), w.device, align=4)
    return v


def wanda_prune_2d(w: torch.Tensor, xnorm: torch.Tensor, tau: torch.Tensor,
                   mode: str = "wanda", alpha: float = 0.5, beta: float = 0.5,
                   rowsum=None, colsum=None, ynorm=None, mu_in=1.0, mu_out=1.0):
    """w (d_in, d_out) f32/bf16; xnorm (d_in,) and tau (d_out,) f32.  RIA:
    rowsum (d_in,), colsum (d_out,); symwanda: ynorm (d_out,) and the scalar
    normalizers mu_in, mu_out.  Returns (w * mask, mask), mask in w's dtype."""
    d_in, d_out = check_weight(w)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, expected one of {sorted(MODES)}")
    _vec(xnorm, "xnorm", d_in, w)
    _vec(tau, "tau", d_out, w)
    if mode == "ria":
        _vec(rowsum, "rowsum", d_in, w)
        _vec(colsum, "colsum", d_out, w)
    elif mode == "symwanda":
        _vec(ynorm, "ynorm", d_out, w)
    mu_in, mu_out = float(mu_in), float(mu_out)      # f32 values, exact
    if w.device.type == "cpu":
        return ref.wanda_prune_ref(w, xnorm, tau, mode, alpha, beta, rowsum, colsum,
                                   ynorm, mu_in, mu_out)
    build.require_cuda(w)
    # ria's xnorm^alpha: the plain version's own torch.pow call, on this device
    xf = xnorm.pow(alpha) if mode == "ria" else xnorm
    out, mask = torch.empty_like(w), torch.empty_like(w)
    build.launch(entry("wanda_prune_2d", w), w.device, w, xf, tau,
                 rowsum if mode == "ria" else None, colsum if mode == "ria" else None,
                 ynorm if mode == "symwanda" else None, out, mask, d_in, d_out,
                 MODES[mode], beta, 1.0 - beta, mu_in, mu_out)
    wanda_prune_2d.launches += 1
    return out, mask


wanda_prune_2d.launches = 0
