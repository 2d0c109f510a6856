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
``efbv_sync_worker`` is one worker's sync of a model's gradient tree over a
process group; under ``qsgd_kernel`` it runs kernel B1 once per leaf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.compressors import (Compressor, lambda_star, nu_star,
                                         omega_ran_independent)
from repro_torch.core.distributed import group_mean
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_unflatten


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


# ---------------------------------------------------------------------------
# One worker's view over a process group (the reference's shard_map form):
# h_i lives on the worker; h_bar is replicated (the same mean on every
# worker keeps it consistent).
# ---------------------------------------------------------------------------
def _compressor_call(c: Compressor):
    return lambda li, x, noise, generator: c(x, noise=noise, generator=generator)


def efbv_sync_worker(grad_tree, h_tree, h_bar_tree, c: Compressor, lam: float,
                     nu: float, group=None, noise=None,
                     generator: Optional[torch.Generator] = None,
                     compress: Optional[Callable] = None):
    """Per-worker EF-BV sync over the ``torch.distributed`` process group
    ``group`` (default: the world), each rank one worker.

    grad_tree / h_tree: this worker's gradient and control variate (trees
    of one structure); h_bar_tree: the replicated average control variate.
    Per leaf, ``d_i = c((g - h) in f32)`` with this rank's draws
    (``noise[li]`` for leaf li, or ``generator``); the mean over ranks is an
    ``all_gather`` of every d_i, summed in rank order by ``group_mean``
    (``group_sum``'s order, then the division), so every rank computes the
    same mean as ``core.distributed.efbv_sync`` does over a stacked group
    axis, bit for bit; an ``all_reduce`` would sum in the backend's order.
    Returns (g_est_tree, new_h_tree, new_h_bar_tree), new tensors (the
    inputs are not changed), each update the source's two operations.

    ``compress(li, x, noise, generator)`` (default: ``c`` on ``x``) takes
    the place of the compressor call on leaf li's f32 delta: a rank that
    holds a shard of each leaf compresses the whole leaf and returns its own
    shard of the result (``training.steps``' per-rank steps)."""
    import torch.distributed as dist

    compress = compress or _compressor_call(c)
    leaves, treedef = tree_flatten(grad_tree)
    h_leaves = tree_flatten(h_tree)[0]
    hb_leaves = tree_flatten(h_bar_tree)[0]
    world = dist.get_world_size(group)
    g_est, new_h, new_hb = [], [], []
    for li, (g, h, hb) in enumerate(zip(leaves, h_leaves, hb_leaves)):
        d_i = compress(li, (g - h).float(), None if noise is None else noise[li],
                       generator).contiguous()
        gathered = d_i.new_empty((world,) + tuple(d_i.shape))
        dist.all_gather(list(gathered.unbind(0)), d_i, group=group)
        d = group_mean(gathered)
        del gathered
        new_h.append(h + lam * d_i)
        g_est.append(hb + nu * d)
        new_hb.append(hb + lam * d)
    return (tree_unflatten(treedef, g_est), tree_unflatten(treedef, new_h),
            tree_unflatten(treedef, new_hb))


def param_sync_worker(param_tree, h_bar_tree, c: Compressor, lam: float, group=None,
                      noise=None, generator: Optional[torch.Generator] = None,
                      compress: Optional[Callable] = None):
    """Per-worker form of one round of ``core.distributed.hier_param_sync``
    over the process group ``group``, each rank one replica: per leaf,
    ``h_bar += lam * mean_i C(p_i - h_bar)`` (the mean an ``all_gather``
    summed in rank order, as ``efbv_sync_worker``'s) and the replica adopts
    ``h_bar`` (``param_tree`` is written in place).  Returns the new h_bar
    tree.  ``compress`` as ``efbv_sync_worker``'s."""
    import torch.distributed as dist

    compress = compress or _compressor_call(c)
    leaves, treedef = tree_flatten(param_tree)
    world = dist.get_world_size(group)
    new_hb = []
    for li, (p, hb) in enumerate(zip(leaves, tree_flatten(h_bar_tree)[0])):
        d_i = compress(li, p.float() - hb, None if noise is None else noise[li],
                       generator).contiguous()
        gathered = d_i.new_empty((world,) + tuple(d_i.shape))
        dist.all_gather(list(gathered.unbind(0)), d_i, group=group)
        hb = hb + lam * group_mean(gathered)
        del gathered
        p.copy_(hb.to(p.dtype))
        new_hb.append(hb)
    return tree_unflatten(treedef, new_hb)

