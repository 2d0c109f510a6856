"""B8: fused pruning score + per-output threshold mask.

Port of ``repro/kernels/wanda_score.py:wanda_prune_2d``: the fused backend of
``core/symwanda.prune``.  The kernel recomputes each weight's score from
O(d_in + d_out) statistics and keeps ``s_ij >= tau_j``:

  wanda     s = |w| * xnorm_i
  ria       s = (|w| / rowsum_i + |w| / colsum_j) * xnorm_i^alpha
  symwanda  s = beta |w| xnorm_i / mu_in + (1 - beta) |w| ynorm_j / mu_out

Two modes of one kernel.  With ``tau`` given (the TPU kernel's contract) it
masks.  With ``tau=None`` it selects: ``tau_j`` is the k-th largest score of
real column j over the real rows (``torch.topk``'s value, NaN ranked above
everything), found on the card from the recomputed scores, so weights are
read once and written once and no score matrix reaches memory; the tau it
found is returned beside the mask.  ``ops.prune_scored`` runs this mode.

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


def wanda_prune_2d(w: torch.Tensor, xnorm: torch.Tensor, tau, mode: str = "wanda",
                   alpha: float = 0.5, beta: float = 0.5, rowsum=None, colsum=None,
                   ynorm=None, mu_in=1.0, mu_out=1.0, k=None, rows=None, cols=None):
    """w (d_in, d_out) f32/bf16; xnorm (d_in,) f32; RIA: rowsum (d_in,),
    colsum (d_out,); symwanda: ynorm (d_out,) and the scalar normalizers
    mu_in, mu_out.

    ``tau`` (d_out,) f32 -> (w * mask, mask), mask in w's dtype.
    ``tau=None`` -> (w * mask, mask, tau): the kernel takes tau_j as the k-th
    largest score of column j < cols over rows < rows (both default to w's
    shape; the padded rest gets tau = +inf)."""
    d_in, d_out = check_weight(w)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, expected one of {sorted(MODES)}")
    _vec(xnorm, "xnorm", d_in, w)
    selecting = tau is None
    if selecting:
        rows = d_in if rows is None else int(rows)
        cols = d_out if cols is None else int(cols)
        if k is None or not (1 <= rows <= d_in and 0 <= cols <= d_out and 1 <= int(k) <= rows):
            raise ValueError(f"selecting needs 1 <= k <= rows <= {d_in} and "
                             f"0 <= cols <= {d_out}; got k={k}, rows={rows}, cols={cols}")
        k = int(k)
    else:
        if (k, rows, cols) != (None, None, None):
            raise ValueError("k, rows and cols belong to the selecting mode (tau=None)")
        _vec(tau, "tau", d_out, w)
    if mode == "ria":
        _vec(rowsum, "rowsum", d_in, w)
        _vec(colsum, "colsum", d_out, w)
    elif mode == "symwanda":
        _vec(ynorm, "ynorm", d_out, w)
    mu_in, mu_out = float(mu_in), float(mu_out)      # f32 values, exact
    if w.device.type == "cpu":
        return ref.wanda_prune_ref(w, xnorm, tau, mode, alpha, beta, rowsum, colsum,
                                   ynorm, mu_in, mu_out, k, rows, cols)
    build.require_cuda(w)
    build.check_tensor(w, "w", w.dtype, w.shape, align=16)   # 16-byte row vectors
    # ria's xnorm^alpha: the plain version's own torch.pow call, on this device
    xf = xnorm.pow(alpha) if mode == "ria" else xnorm
    out, mask = torch.empty_like(w), torch.empty_like(w)
    if selecting:
        tau = torch.empty(d_out, dtype=torch.float32, device=w.device)
    build.launch(entry("wanda_prune_2d", w), w.device, w, xf, tau,
                 rowsum if mode == "ria" else None, colsum if mode == "ria" else None,
                 ynorm if mode == "symwanda" else None, out, mask, d_in, d_out,
                 MODES[mode], beta, 1.0 - beta, mu_in, mu_out, int(selecting),
                 k or 0, d_in if rows is None else rows, d_out if cols is None else cols)
    wanda_prune_2d.launches += 1
    if selecting:
        wanda_prune_2d.selecting += 1
        return out, mask, tau
    return out, mask


wanda_prune_2d.launches = 0
wanda_prune_2d.selecting = 0
