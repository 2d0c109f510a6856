"""Scafflix: explicit personalization + accelerated local training (Ch. 3);
port of ``repro/core/scafflix.py``.

Algorithm 4 on the (FLIX) objective
    min_x  (1/n) sum_i f_i( alpha_i x + (1-alpha_i) x_i* ),
where x_i* = argmin f_i is each client's locally-optimal model.

Per round t (prob-p communication):
    xt_i   = alpha_i x_i + (1-alpha_i) x_i*          # personalized estimate
    g_i    = (stochastic) grad f_i(xt_i)
    xh_i   = x_i - (gamma_i/alpha_i) (g_i - h_i)     # local step
    w.p. p:  xbar = (gamma/n) sum_j (alpha_j^2/gamma_j) xh_j  (server)
             x_i <- xbar;  h_i += (p alpha_i / gamma_i)(xbar - xh_i)
    else:    x_i <- xh_i
with gamma = ( (1/n) sum alpha_i^2 / gamma_i )^{-1}.

The coin is injected: round t communicates when ``u[t] < p`` for a uniform
``u[t]`` in [0, 1) (``jax.random.bernoulli(key, p)`` is ``uniform(key) <
p``), so the tests replay the JAX package's rounds exactly.  Client means
sum in ``distributed.group_sum``'s order; a round equals the JAX function
run op by op bit for bit.  Plain torch, as the reference is plain jnp.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.distributed import group_mean


class ScafflixState(NamedTuple):
    x: torch.Tensor        # (n, d) per-client iterates
    h: torch.Tensor        # (n, d) control variates (sum_i h_i = 0 invariant)
    x_star: torch.Tensor   # (n, d) local optima (personalization anchors)


def scafflix_init(x0: torch.Tensor, n: int, x_star: torch.Tensor) -> ScafflixState:
    return ScafflixState(x=x0[None].repeat(n, 1), h=torch.zeros((n, x0.shape[0]),
                                                                dtype=x0.dtype,
                                                                device=x0.device),
                         x_star=x_star)


def scafflix_round(state: ScafflixState, grad_fn: Callable, p: float,
                   gammas: torch.Tensor, alphas: torch.Tensor, u: torch.Tensor):
    """One Scafflix round.  grad_fn(xt: (n, d)) -> (n, d) per-client
    gradients at the personalized points; ``u`` is the round's uniform draw
    (a 0-d tensor).  Returns (new_state, communicated: a 0-d bool tensor)."""
    n = state.x.shape[0]
    a = alphas[:, None]
    xt = a * state.x + (1 - a) * state.x_star
    g = grad_fn(xt)
    xh = state.x - (gammas / alphas)[:, None] * (g - state.h)

    theta = u < p
    gamma_srv = 1.0 / group_mean(alphas**2 / gammas)
    w = (alphas**2 / gammas)[:, None]
    xbar = gamma_srv * group_mean(w * xh)

    x_comm = xbar[None].expand(n, -1)
    h_comm = state.h + (p * alphas / gammas)[:, None] * (xbar[None] - xh)

    new_x = torch.where(theta, x_comm, xh)
    new_h = torch.where(theta, h_comm, state.h)
    return ScafflixState(x=new_x, h=new_h, x_star=state.x_star), theta


def scafflix_run(state: ScafflixState, grad_fn: Callable, p: float, gammas, alphas,
                 rounds: int, eval_fn: Optional[Callable] = None, u=None,
                 generator: Optional[torch.Generator] = None):
    """Returns (final state, (per-round metric (rounds,), communicated
    (rounds,) bool)), both on the state's device.  ``u`` (rounds,) holds the
    rounds' uniform draws; without it they come from ``generator``."""
    dev = state.x.device
    if u is None:
        if generator is None:
            raise ValueError("scafflix_run needs its coin draws: u= or generator=")
        u = torch.rand((rounds,), generator=generator, device=generator.device)
    u = u.to(device=dev, dtype=torch.float32)
    metrics = torch.zeros((rounds,), dtype=state.x.dtype, device=dev)
    comms = torch.zeros((rounds,), dtype=torch.bool, device=dev)
    for t in range(rounds):
        state, comms[t] = scafflix_round(state, grad_fn, p, gammas, alphas, u[t])
        if eval_fn is not None:
            metrics[t] = eval_fn(state)
    return state, (metrics, comms)


# ---------------------------------------------------------------------------
# FLIX helpers on the federated logreg problem (Ch. 3.3.1 experiments)
# ---------------------------------------------------------------------------
def flix_objective(x, A, b, mu, alphas, x_star):
    """f~(x) = (1/n) sum_i f_i(alpha_i x + (1-alpha_i) x_i*)."""
    xt = alphas[:, None] * x[None] + (1 - alphas[:, None]) * x_star      # (n, d)
    z = torch.einsum("nmd,nd->nm", A, xt)
    loss = torch.log1p(torch.exp(-b * z)).mean(1) + 0.5 * mu * (xt**2).sum(1)
    return loss.mean()


def logreg_grads(xt, A, b, mu):
    """Per-client logreg gradients at per-client points xt (n, d)."""
    z = torch.einsum("nmd,nd->nm", A, xt)
    s = -b * torch.sigmoid(-b * z)            # d/dz log(1+exp(-bz))
    g = torch.einsum("nm,nmd->nd", s, A) / A.shape[1]
    return g + mu * xt


def local_optimum(A_i, b_i, mu, steps: int = 500, tol: float = 1e-10):
    """x_i* = argmin f_i via Newton (the logreg Hessian is closed-form); runs
    ``steps`` iterations and freezes x once ||g|| < tol, as the reference's
    scan does (no read-back to the host)."""
    m, d = A_i.shape
    eye = torch.eye(d, dtype=A_i.dtype, device=A_i.device)
    x = torch.zeros((d,), dtype=A_i.dtype, device=A_i.device)
    done = torch.zeros((), dtype=torch.bool, device=A_i.device)
    for _ in range(steps):
        sig = torch.sigmoid(-b_i * (A_i @ x))
        g = (A_i.T @ (-b_i * sig)) / m + mu * x
        H = (A_i.T * (sig * (1 - sig))) @ A_i / m + mu * eye
        x = torch.where(done, x, x - torch.linalg.solve(H, g))
        done = done | (torch.linalg.norm(g) < tol)
    return x


def flix_grad(x, A, b, mu, alphas, x_star):
    """The gradient of ``flix_objective`` in x: (1/n) sum_i alpha_i
    nabla f_i(xt_i) (the reference takes ``jax.grad``; equal up to
    rounding)."""
    xt = alphas[:, None] * x[None] + (1 - alphas[:, None]) * x_star
    return (alphas[:, None] * logreg_grads(xt, A, b, mu)).mean(0)


def flix_optimum(A, b, mu, alphas, x_star, steps: int = 2000, lr: float = None):
    """Solve (FLIX) to high precision with GD (convex, smooth)."""
    n, m, d = A.shape
    L = (A**2).sum((1, 2)).max() / (4 * m) + mu
    lr = (1.0 / L) if lr is None else lr
    x = torch.zeros((d,), dtype=A.dtype, device=A.device)
    for _ in range(steps):
        x = x - lr * flix_grad(x, A, b, mu, alphas, x_star)
    return x
