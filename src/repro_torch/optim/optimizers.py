"""Optimizers as (init, update) pairs over trees (port of
``repro/optim/optimizers.py``).

The functions are the reference's, not ``torch.optim``'s: AdamW here adds
``weight_decay * p`` into the update ``u`` and casts ``-lr * u`` to the
parameter dtype, where ``torch.optim.AdamW`` decays the parameter before the
step.  Every moment update is written as the reference's separate
multiplies and adds (never an ``alpha=`` add or a lerp, which fuse them).

Differences that change no value:

* ``OptState.step`` is the host-side step counter (a Python int).
* The state is updated in place and returned (the jitted JAX step donates
  it).
* ``Optimizer.step(grads, state, params, scale)`` is ``update`` followed by
  ``apply_updates``, in place, slice by slice along each leaf's first axis,
  with ``clip_by_global_norm``'s multiply folded in as ``g.float() *
  scale``: the values equal the three calls', and a full-width step never
  holds an f32 copy of the gradient or a tree of updates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

_F32 = torch.float32
SLICE_ELEMS = tree_lib.SLICE_ELEMS    # elements per in-place slice of a leaf in ``step``


class OptState(NamedTuple):
    step: int
    mu: object       # first moment (or momentum); () for sgd without momentum
    nu: object       # second moment; () for sgd


@dataclass(frozen=True)
class Optimizer:
    """``update`` (+ ``apply_updates``) is the reference's functional API,
    kept for its callers and the parity tests; the train step uses ``step``,
    the same values in place."""
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    step: Callable    # (grads, state, params, scale) -> new_state


def tree_norm(tree) -> torch.Tensor:
    """``utils.tree.tree_norm`` in this module's ``SLICE_ELEMS`` slices: the
    grad norm of ``clip_by_global_norm`` and of the train step."""
    return tree_lib.tree_norm(tree, SLICE_ELEMS)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-9))`` in f32, on the norm's device."""
    # a true division (``float / tensor`` would multiply by a reciprocal)
    return torch.clamp(norm.new_tensor(max_norm) / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads * scale in f32, norm), as the reference's promotion gives."""
    norm = tree_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _slices(t: torch.Tensor):
    """Index slices of ``t`` along its first axis, about SLICE_ELEMS
    elements each."""
    return tree_lib.leaf_slices(t, SLICE_ELEMS)


def _bias_corrections(b1: float, b2: float, step: int):
    s = torch.tensor(float(step), dtype=_F32)
    return (float(1 - torch.tensor(b1, dtype=_F32) ** s),
            float(1 - torch.tensor(b2, dtype=_F32) ** s))


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, mask: Optional[Callable] = None) -> Optimizer:
    """AdamW with decoupled weight decay; ``mask(p)`` selects the leaves
    that decay (default: ndim >= 2)."""
    sched = lr if callable(lr) else (lambda _: float(torch.tensor(lr, dtype=_F32)))
    decay_mask = mask or (lambda p: p.dim() >= 2)

    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                                       device=p.device), params)
        return OptState(step=0, mu=zeros(), nu=zeros())

    def _moments_(m, v, g32):
        m.mul_(b1).add_(g32 * (1 - b1))                 # b1 * m + (1 - b1) * g
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))  # b2 * v + (1 - b2) * g^2

    def _u(m, v, p, b1c, b2c, decay):
        u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if decay:
            u = u + weight_decay * p.float()
        return u

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = sched(step)
        b1c, b2c = _bias_corrections(b1, b2, step)
        g_l, treedef = tree_flatten(grads)
        m_l, v_l, p_l = (tree_flatten(t)[0] for t in (state.mu, state.nu, params))
        updates = []
        for g, m, v, p in zip(g_l, m_l, v_l, p_l):
            _moments_(m, v, g.float())
            updates.append((-lr_t * _u(m, v, p, b1c, b2c, decay_mask(p))).to(p.dtype))
        return tree_unflatten(treedef, updates), OptState(step, state.mu, state.nu)

    def step_(grads, state: OptState, params, scale):
        step = state.step + 1
        lr_t = sched(step)
        b1c, b2c = _bias_corrections(b1, b2, step)
        leaves = zip(*(tree_flatten(t)[0] for t in (grads, state.mu, state.nu, params)))
        with torch.no_grad():
            for g, m, v, p in leaves:
                decay = decay_mask(p)
                for sl in _slices(p):
                    _moments_(m[sl], v[sl], g[sl].float() * scale)
                    upd = (-lr_t * _u(m[sl], v[sl], p[sl], b1c, b2c, decay)).to(p.dtype)
                    p[sl].add_(upd)
                    del upd
        return OptState(step, state.mu, state.nu)

    return Optimizer(init=init, update=update, step=step_)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = lr if callable(lr) else (lambda _: float(torch.tensor(lr, dtype=_F32)))

    def init(params):
        mu = (tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)
              if momentum else ())
        return OptState(step=0, mu=mu, nu=())

    def _eff(m, g32):
        """momentum * m + g into ``m`` in place -> the effective direction."""
        m.mul_(momentum).add_(g32)
        return m * momentum + g32 if nesterov else m

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = sched(step)
        if momentum:
            updates = tree_map(lambda m, g, p: (-lr_t * _eff(m, g.float())).to(p.dtype),
                               state.mu, grads, params)
        else:
            updates = tree_map(lambda g, p: (-lr_t * g.float()).to(p.dtype), grads, params)
        return updates, OptState(step, state.mu, ())

    def step_(grads, state: OptState, params, scale):
        step = state.step + 1
        lr_t = sched(step)
        g_l, p_l = tree_flatten(grads)[0], tree_flatten(params)[0]
        m_l = tree_flatten(state.mu)[0] if momentum else [None] * len(p_l)
        with torch.no_grad():
            for g, m, p in zip(g_l, m_l, p_l):
                for sl in _slices(p):
                    g32 = g[sl].float() * scale
                    eff = _eff(m[sl], g32) if momentum else g32
                    p[sl].add_((-lr_t * eff).to(p.dtype))
        return OptState(step, state.mu, ())

    return Optimizer(init=init, update=update, step=step_)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
