"""EF-BV: Error Feedback with Bias-Variance decomposition (Ch. 2, Fig. 2.1);
port of ``repro/core/ef_bv.py``.

The federated simulation form of Algorithm 1 on stacked per-client
gradients (n, d): it reproduces the paper's experiments (Fig. 2.2
bits-vs-suboptimality) and recovers EF21 (nu = lambda) and DIANA (nu = 1)
by parameter choice.  The training runtime's sync is
``core.distributed.efbv_sync``.

State: per-client control variates h_i -> nabla f_i(x*) and the maintained
average h_bar = mean_i h_i.  Per round:
    d_i    = C_i(g_i - h_i)
    d      = mean_i d_i                  (the only communication)
    h_i   += lambda * d_i
    g_est  = h_bar + nu * d
    h_bar += lambda * d

Randomness is injected: client i's compressor draw of a round is
``noise[i]`` (the compressor's own draw shape, ``core/compressors.py``), or
comes from one explicit ``torch.Generator``.  The client mean sums in
``distributed.group_sum``'s order, and ``h + lam * d`` stays two
operations, so a round equals the JAX function run op by op bit for bit.
This is plain torch, as the reference is plain jnp: it reaches no kernel.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.compressors import (Compressor, lambda_star, nu_star,
                                         omega_ran_independent)
from repro_torch.core.distributed import group_mean
from repro_torch.utils.device import resolve_device


class EFBVState(NamedTuple):
    h: torch.Tensor       # (n, d) per-client control variates
    h_bar: torch.Tensor   # (d,) maintained average


def efbv_init(n: int, d: int, dtype=torch.float32, device=None) -> EFBVState:
    device = resolve_device(device)
    return EFBVState(h=torch.zeros((n, d), dtype=dtype, device=device),
                     h_bar=torch.zeros((d,), dtype=dtype, device=device))


def efbv_params(c: Compressor, n: int, mode: str = "efbv",
                eta: Optional[float] = None, omega: Optional[float] = None):
    """(lambda, nu) for the three algorithms of Fig. 2.1.

    mode: efbv   -> lambda = lambda*(eta, omega), nu = nu*(eta, omega/n)
          ef21   -> nu = lambda = lambda*  (biased-contractive error feedback)
          diana  -> lambda = 1/(1+omega), nu = 1 (variance reduction)
    """
    eta = c.eta if eta is None else eta
    omega = c.omega if omega is None else omega
    if eta is None or omega is None:
        raise ValueError(f"compressor {c.name} needs (eta, omega); estimate them first")
    om_ran = omega_ran_independent(omega, n) if not c.deterministic else omega
    lam = lambda_star(eta, omega)
    if mode == "efbv":
        return lam, nu_star(eta, om_ran)
    if mode == "ef21":
        return lam, lam
    if mode == "diana":
        return 1.0 / (1.0 + omega), 1.0
    raise ValueError(mode)


def efbv_round(grads: torch.Tensor, state: EFBVState, c: Compressor, lam: float,
               nu: float, noise=None, generator: Optional[torch.Generator] = None):
    """One EF-BV communication round on stacked client gradients.

    grads: (n, d) = [nabla f_i(x^t)]_i; ``noise[i]`` is client i's draw.
    Returns (g_est (d,), new_state).  Each client draws independently, so
    omega_ran = omega / n."""
    delta = grads - state.h
    d_i = torch.stack([c(delta[i], noise=None if noise is None else noise[i],
                         generator=generator) for i in range(grads.shape[0])])
    d = group_mean(d_i)
    new_h = state.h + lam * d_i
    g_est = state.h_bar + nu * d
    new_h_bar = state.h_bar + lam * d
    return g_est, EFBVState(h=new_h, h_bar=new_h_bar)


def efbv_gd(x0: torch.Tensor, grad_fn: Callable, state: EFBVState, c: Compressor,
            lam: float, nu: float, gamma: float, steps: int,
            f_fn: Optional[Callable] = None, noise=None,
            generator: Optional[torch.Generator] = None):
    """Run EF-BV distributed (proximal-free) GD for ``steps`` rounds.

    grad_fn(x) -> (n, d) stacked client gradients; ``noise[t]`` is round
    t's draws, (n, ...).  Returns the final x, state and the per-round
    objective trace (steps,) (zeros without ``f_fn``), kept on x0's device:
    nothing is read back to the host inside the loop."""
    trace = torch.zeros((steps,), dtype=x0.dtype, device=x0.device)
    x = x0
    for t in range(steps):
        g, state = efbv_round(grad_fn(x), state, c, lam, nu,
                              noise=None if noise is None else noise[t],
                              generator=generator)
        x = x - gamma * g
        if f_fn is not None:
            trace[t] = f_fn(x)
    return x, state, trace


def efbv_sync_worker(*args, **kwargs):
    """The reference's per-worker EF-BV sync inside ``shard_map``.  One
    process's simulation of every worker is ``core.distributed.efbv_sync``;
    the per-worker form over ``torch.distributed`` belongs to the multi-GPU
    slice."""
    raise NotImplementedError(
        "efbv_sync_worker (the per-worker form over a device mesh) is not ported "
        "yet (ROADMAP.md Queue 1, item 8: Multi-GPU); core.distributed.efbv_sync "
        "runs every worker's sync in one process")
