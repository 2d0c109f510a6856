"""SymWanda: symmetric post-training pruning + R^2-DSnoT (Ch. 6); port of
``repro/core/symwanda.py``.

Scores for pruning a weight matrix W (out = X @ W, X: (tokens, d_in)):

  magnitude   S_ij = |W_ij|
  wanda       S_ij = |W_ij| * ||X_:i||_2          (input-activation aware)
  ria         S_ij = (|W_ij|/sum_k|W_kj| + |W_ij|/sum_k|W_ik|) * ||X_:i||^alpha
  symwanda    beta * wanda-term + (1-beta) * output-side term |W_ij| ||Y_:j||
  stochria    RIA from a row subsample of the calibration batch

Masking: unstructured (global or per-output) and N:M structured (2:4).
R^2-DSnoT: training-free prune-and-grow with a relative-importance
regularized decision boundary.  dtypes follow the JAX package's promotion:
a bf16 W scored against f32 norms gives f32 scores, masks and ``W * mask``.

Randomness is injected: ``stochria`` takes its sampled rows as ``idx`` or
draws them from an explicit ``torch.Generator``.  The fused kernel backends
of ``mask_nm`` and ``prune`` are ``kernels.ops.prune_nm`` / ``prune_scored``
(B7 / B8), which ``launch/prune.py`` calls; this module is the plain torch
the JAX package's module is, with the same options and defaults.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.ops import input_norms

EPS = 1e-12


# ---------------------------------------------------------------------------
# Activation statistics from a calibration batch
# ---------------------------------------------------------------------------
def act_norms(X: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """Per-input-channel lp norms ||X_:i||_p of calibration activations
    (T, d_in) in f32 (the paper's App. E.3.2/E.3.3 sweep of p: 1, 2, inf).
    p=2 is the fused prune's own ``input_norms``, so the module and the
    kernel path score alike."""
    if p == 2.0:
        return input_norms(X)
    Xa = X.float().abs()
    if p == math.inf:
        return Xa.amax(0)
    return Xa.pow(p).sum(0).pow(1.0 / p)


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------
def score_magnitude(W, X=None, **kw):
    return W.abs()


def score_wanda(W, X, p: float = 2.0, **kw):
    return W.abs() * act_norms(X, p)[:, None]


def score_ria(W, X, alpha: float = 0.5, p: float = 2.0, **kw):
    aW = W.abs()
    row_sum = aW.sum(1, keepdim=True)       # sum over outputs for input i
    col_sum = aW.sum(0, keepdim=True)       # sum over inputs for output j
    ri = aW / row_sum.clamp_min(EPS) + aW / col_sum.clamp_min(EPS)
    return ri * act_norms(X, p)[:, None].pow(alpha)


def score_symwanda(W, X, beta: float = 0.5, Y: Optional[torch.Tensor] = None, **kw):
    """Symmetric objective: input-side ||X_:i|| and output-side ||Y_:j||
    terms, each normalized by its mean.  Y defaults to the layer's
    calibration output X @ W."""
    inp = W.abs() * act_norms(X)[:, None]
    out = W.abs() * act_norms(X @ W if Y is None else Y)[None, :]
    inp = inp / inp.mean().clamp_min(EPS)
    out = out / out.mean().clamp_min(EPS)
    return beta * inp + (1.0 - beta) * out


def score_stochria(W, X, sample_frac: float = 0.1, idx: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, alpha: float = 0.5, **kw):
    """RIA from sampled calibration rows: ``idx`` when given (how the tests
    inject the JAX package's draw of ``max(1, int(sample_frac * T))``
    distinct rows), else that many rows of a random permutation drawn from
    ``generator``."""
    if idx is None:
        if generator is None:
            raise ValueError("stochria needs its sampled rows: idx= or generator=")
        k = max(1, int(sample_frac * X.shape[0]))
        idx = torch.randperm(X.shape[0], generator=generator,
                             device=generator.device)[:k]
    return score_ria(W, X[idx.to(X.device)], alpha=alpha)


SCORES = {
    "magnitude": score_magnitude,
    "wanda": score_wanda,
    "ria": score_ria,
    "symwanda": score_symwanda,
    "stochria": score_stochria,
}


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------
def mask_unstructured(S: torch.Tensor, sparsity: float, per_output: bool = True):
    """Keep the top (1-sparsity) fraction by score (every score at or above
    the k-th): of every output column, as Wanda prunes, or of the whole
    matrix (``per_output=False``)."""
    if per_output:
        k = max(1, int(round((1 - sparsity) * S.shape[0])))
        thresh = torch.topk(S.T, k).values[:, -1]          # per column j
        return (S >= thresh[None, :]).to(S.dtype)
    k = max(1, int(round((1 - sparsity) * S.numel())))
    thresh = torch.topk(S.reshape(-1), k).values[-1]
    return (S >= thresh).to(S.dtype)


def mask_nm(S: torch.Tensor, n: int = 2, m: int = 4):
    """N:M structured: keep the n largest scores (and any tied with the
    n-th) in every group of m along the input dim."""
    d_in, d_out = S.shape
    if d_in % m:
        raise ValueError(f"d_in {d_in} is not a multiple of m {m}")
    grp = S.T.reshape(d_out, d_in // m, m)           # (out, groups, m)
    thresh = torch.topk(grp, n).values[..., -1:]
    return (grp >= thresh).to(S.dtype).reshape(d_out, d_in).T


def prune(W, X, method: str = "wanda", sparsity: float = 0.5,
          structured_nm: Optional[tuple] = None, **score_kw):
    """Returns (pruned W, mask)."""
    S = SCORES[method](W, X, **score_kw)
    if structured_nm is not None:
        mask = mask_nm(S, *structured_nm)
    else:
        mask = mask_unstructured(S, sparsity)
    return W * mask, mask


# ---------------------------------------------------------------------------
# Reconstruction metrics (the paper's minimization objective, Sect. 6.3)
# ---------------------------------------------------------------------------
def reconstruction_error(W, W_pruned, X) -> torch.Tensor:
    """||X W - X W~||_F / ||X W||_F (input-side objective)."""
    Y, Yp = X @ W, X @ W_pruned
    return torch.linalg.norm(Y - Yp) / torch.linalg.norm(Y).clamp_min(EPS)


def symmetric_error(W, W_pruned, X, Z) -> torch.Tensor:
    """Symmetric objective ||X dW||_F + ||dW^T Z||_F (Z: output-side probe)."""
    dW = W - W_pruned
    return torch.linalg.norm(X @ dW) + torch.linalg.norm(dW.T @ Z)


# ---------------------------------------------------------------------------
# R^2-DSnoT: training-free prune-and-grow fine-tuning (Sect. 6.3.6)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DSnoTConfig:
    iters: int = 20
    swap_frac: float = 0.02        # as the reference: declared, read by neither
                                   # package (one swap per column per iteration)
    reg: float = 0.5               # relative-importance regularization strength
    use_ria_boundary: bool = True  # R^2 variant; False = vanilla DSnoT


def r2_dsnot(W, mask, X, cfg: DSnoTConfig = DSnoTConfig(), ria_alpha: float = 0.5):
    """Iteratively swap one pruned and one kept weight per output column
    when the swap reduces the reconstruction error.

    Growth: the pruned weight whose reinstatement best cancels the output
    residual; pruning: the kept weight of least error increase, plus
    ``cfg.reg`` * relative importance (RIA at ``ria_alpha``) when
    ``cfg.use_ria_boundary``.  Ties go to the first row (``argmin``), as
    ``jax.lax.top_k`` breaks them.  Returns (W * mask, mask)."""
    Xf = X.float()
    Xn2 = Xf.square().sum(0)                                   # (d_in,) ||X_:i||^2
    Wf = W.float()
    if cfg.use_ria_boundary:
        ria = score_ria(W, X, alpha=ria_alpha)
        ria = ria / ria.mean().clamp_min(EPS)
        reg_term = cfg.reg * Wf.abs() * Xn2.sqrt()[:, None] * ria
    quad = Wf.square() * Xn2[:, None]
    cols = torch.arange(W.shape[1], device=W.device)

    for _ in range(cfg.iters):
        # residual R = X (W - W~); growing W_ij changes ||R||^2 by
        # -2 W_ij (X^T R)_ij + W_ij^2 ||X_:i||^2, pruning it by +2 W_ij (X^T R)_ij + ...
        R = Xf @ (Wf * (1 - mask))                             # (T, d_out)
        XtR = Xf.T @ R                                         # (d_in, d_out)
        kept = mask > 0
        grow_score = torch.where(kept, math.inf, -2.0 * Wf * XtR + quad)
        prune_delta = 2.0 * Wf * XtR + quad
        if cfg.use_ria_boundary:
            prune_delta = prune_delta + reg_term       # R^2: regularized boundary
        prune_score = torch.where(kept, prune_delta, math.inf)
        grow_idx, prune_idx = grow_score.argmin(0), prune_score.argmin(0)
        grow_val, prune_val = grow_score[grow_idx, cols], prune_score[prune_idx, cols]
        do = -(grow_val + prune_val) > 0                       # the swap reduces error
        mask = mask.clone()
        mask[grow_idx, cols] = torch.where(do, 1.0, mask[grow_idx, cols])
        mask[prune_idx, cols] = torch.where(do, 0.0, mask[prune_idx, cols])
    return W * mask, mask
