"""SymWanda post-training pruning entry point (Ch. 6): the loss ladder.

  PYTHONPATH=src python -m repro_torch.launch.prune --arch h2o-danube-1.8b
  ... --reduced --device cpu               # a tiny config on the CPU
  ... --ckpt results/ckpt                  # prune trained params

Counterpart of ``examples/prune_llm.py``: collect calibration activations
(layer 0's ``norm1`` of an embedded 8 x 64 token batch), prune every MLP
``w_in`` with magnitude / Wanda / RIA / SymWanda at 50% and 60% sparsity
and with Wanda under 2:4, apply R^2-DSnoT after Wanda, and print each
method's LM loss beside the dense one.  Weights are random, from
``--seed``, or the trained params of ``--ckpt``: a checkpoint written by
``launch.train --ckpt`` or by the JAX package's ``save_checkpoint``, whose
leaves must match what ``--arch`` builds (else it raises); of a replica run
(``local`` / ``hier``, a leading replica axis) it takes replica 0.

Routes: wanda, ria and symwanda run the fused score-and-mask kernel (B8,
``ops.prune_scored``); an N:M pattern runs B7 (``ops.prune_nm``) on the
method's scores; magnitude and R^2-DSnoT are plain torch, as in the JAX
package.  A pruned ``w_in`` keeps the model's dtype (its values are
``W`` or 0 either way).
"""
from __future__ import annotations

import argparse
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import symwanda as sw
from repro_torch.kernels import ops
from repro_torch.models import forward_train
from repro_torch.models.layers import cross_entropy_loss, embed, rmsnorm

FUSED = ("wanda", "ria", "symwanda")         # methods B8 scores itself
METHODS = ("magnitude",) + FUSED
SPARSITIES = (0.5, 0.6)
CALIB_BATCH, CALIB_SEQ = 8, 64              # examples/prune_llm.py's batch


def calib_batch(cfg, seed: int, device) -> dict:
    """Random tokens from ``seed``: {"tokens", "targets"}, each (CALIB_BATCH,
    CALIB_SEQ), targets the tokens shifted by one."""
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size,
                                                (CALIB_BATCH, CALIB_SEQ + 1))
    toks = torch.as_tensor(toks, dtype=torch.long, device=device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def calib_acts(params, cfg, batch) -> torch.Tensor:
    """Layer 0's ``norm1`` output on the embedded batch -> (tokens, d_model)."""
    x = embed(params["embed"], batch["tokens"])
    norm1 = {k: v[0] for k, v in params["blocks"]["pos0"]["norm1"].items()}
    return rmsnorm(norm1, x).reshape(-1, cfg.d_model)


def prune_layer(W, X, method: str, sparsity: float,
                structured_nm: Optional[tuple] = None):
    """Prune one (d_in, d_out) weight -> (pruned W in W's dtype, mask).
    (``stochria`` needs its sampled rows: call ``sw.prune`` with ``idx=`` or
    ``generator=``.)"""
    if structured_nm is not None:
        return ops.prune_nm(W, sw.SCORES[method](W, X), *structured_nm)
    if method in FUSED:
        return ops.prune_scored(W, X, mode=method, sparsity=sparsity)
    Wp, mask = sw.prune(W, X, method=method, sparsity=sparsity)
    return Wp.to(W.dtype), mask


def prune_all_mlps(params, X, method: str, sparsity: float, dsnot: bool = False,
                   structured_nm: Optional[tuple] = None):
    """A copy of ``params`` whose every stacked ``mlp.w_in`` is pruned; the
    other leaves are shared, not copied."""
    blocks = {}
    for pos, bp in params["blocks"].items():
        if "mlp" not in bp:
            blocks[pos] = bp
            continue
        stack = bp["mlp"]["w_in"]
        new = torch.empty_like(stack)
        for li in range(stack.shape[0]):
            W = stack[li]
            Wp, mask = prune_layer(W, X, method, sparsity, structured_nm)
            if dsnot:
                Wp, _ = sw.r2_dsnot(W, mask, X, sw.DSnoTConfig(iters=20))
            new[li] = Wp
            del Wp, mask
        blocks[pos] = {**bp, "mlp": {**bp["mlp"], "w_in": new}}
    return {**params, "blocks": blocks}


def lm_loss(params, cfg, batch) -> float:
    """Mean next-token CE over all logits rows, as ``examples/prune_llm.py``
    reports it."""
    logits, _ = forward_train(params, cfg, batch)
    return float(cross_entropy_loss(logits, batch["targets"]))


def loss_ladder(params, cfg, batch, log=print) -> dict:
    """Dense loss, then every method at each sparsity, Wanda + R^2-DSnoT, and
    Wanda 2:4 -> {label: loss}."""
    X = calib_acts(params, cfg, batch)
    out = {"dense": lm_loss(params, cfg, batch)}
    base = out["dense"]
    log(f"dense loss: {base:.4f} (ln vocab {math.log(cfg.vocab_size):.4f})")

    def row(label, pruned):
        out[label] = loss = lm_loss(pruned, cfg, batch)
        log(f"  {label:18s} loss {loss:.4f} ({loss - base:+.4f})")

    for sparsity in SPARSITIES:
        log(f"-- sparsity {sparsity:.0%} --")
        for method in METHODS:
            row(f"{method}@{sparsity}", prune_all_mlps(params, X, method, sparsity))
        row(f"wanda+R2DSnoT@{sparsity}",
            prune_all_mlps(params, X, "wanda", sparsity, dsnot=True))
    log("-- 2:4 --")
    row("wanda@2:4", prune_all_mlps(params, X, "wanda", 0.5, structured_nm=(2, 4)))
    return out


def load_params(path: str, cfg, device) -> dict:
    """The params of checkpoint ``path`` in the tree, dtypes and shapes that
    ``cfg`` builds on ``device``; replica 0 of a replica run's checkpoint.
    A missing, extra or differently shaped leaf raises ValueError."""
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import load_checkpoint, stored_shape
    from repro_torch.utils.tree import tree_leaves

    like = init_params(0, cfg, device="meta")       # the structure, no storage
    stacked = len(stored_shape(path)) == tree_leaves(like)[0].dim() + 1
    return load_checkpoint(path, like, replica=0 if stacked else None, device=device)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="prune the params of this checkpoint (default: random "
                         "weights from --seed)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ckpt:
        params = load_params(args.ckpt, cfg, device)
    else:
        params = init_params(args.seed, cfg, device=device)
    return loss_ladder(params, cfg, calib_batch(cfg, args.seed, device))


if __name__ == "__main__":
    main()
