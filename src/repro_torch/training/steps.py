"""Train-step builders (port of ``repro/training/steps.py``).

Three step flavors, keyed by ``SyncConfig.mode``:

  dense            shared params, global-batch loss, plain gradient
                   (``grad_accum`` > 1 accumulates microbatches in f32)
  efbv/ef21/diana  one backward per worker group (the JAX package's
                   ``vmap(grad)`` becomes a loop), EF-BV compressed-delta
                   sync of the per-group gradients (Ch. 2)
  hier / local     per-group replicas, each with its own optimizer step,
                   EF21-compressed parameter sync every ``sync_period`` steps
                   or through the aggregation-tree cascade (Ch. 3 / Ch. 5)

``make_prefill_step`` / ``make_decode_step`` wrap the model's prefill and
decode for one config, as the reference's serving factories do.

A step is ``step(state, batch, survivors=None, noise=None) -> (state,
metrics)``.  Its draws come from ``TrainState.generator``; ``noise`` (a
test hook) hands the sync the JAX package's draws instead, nested as
``core.distributed`` documents.  The state is updated in place and
returned; metrics stay on the device (0-d tensors).

Memory at full width: the efbv step writes each group's gradient straight
into one (G, nb, B) f32 bucket buffer and drops it, the sync updates the
bucketed control variates in place, and the optimizer folds the clip's
multiply into its in-place pass (``Optimizer.step``), so no f32 copy of the
gradient tree is ever held.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.comm import buckets as bk
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import distributed as dist
from repro_torch.models import decode_step as model_decode_step
from repro_torch.models import loss_fn, prefill
from repro_torch.models.layers import embed
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.optimizers import (OptState, clip_scale, make_optimizer,
                                          tree_norm)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.sharding.context import constrain_grads
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: object
    opt_state: object
    sync_state: object       # dist.SyncState / TreeSyncState, or None
    generator: torch.Generator


def _make_optimizer(tc: TrainConfig):
    sched = cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
    return make_optimizer(tc.optimizer, sched, weight_decay=tc.weight_decay)


def _cascade_leaves(cascade) -> int:
    n = 1
    for lev in cascade:
        n *= lev.fanout
    return n


def init_train_state(generator: torch.Generator, params, tc: TrainConfig,
                     n_groups: int, n_pods: int) -> TrainState:
    """Optimizer and sync state for ``tc.sync.mode``.  Replica modes copy
    ``params`` into a leading group axis; the caller may then drop them."""
    opt = _make_optimizer(tc)
    mode = tc.sync.mode
    if mode in ("hier", "local"):
        if mode == "hier" and tc.sync.levels:
            cascade = dist.build_cascade(tc.sync)
            G = _cascade_leaves(cascade)
            sync_state = dist.tree_sync_state_init(params, cascade)
        else:
            G = n_pods if mode == "hier" else n_groups
            h_bar = tree_map(lambda p: p.float().clone(), params)
            sync_state = dist.SyncState(h=(), h_bar=h_bar, step=0)
        params_g = tree_map(lambda p: p[None].expand((G,) + tuple(p.shape)).clone(), params)
        return TrainState(params_g, opt.init(params_g), sync_state, generator)
    sync_state = (dist.sync_state_init(params, n_groups, tc.sync, n_pods)
                  if mode != "dense" else None)
    return TrainState(params, opt.init(params), sync_state, generator)


def _split(batch: dict, G: int, i: int) -> dict:
    """Group ``i`` of ``G`` equal slices of every batch array."""
    return {k: v.reshape((G, v.shape[0] // G) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_groups: int, n_pods: int):
    """The step for ``tc.sync.mode``.  Its phases are ``obs.trace`` spans:
    ``step/grad`` (forward + backward), ``step/sync`` (the fused efbv step's
    bucketize of each group's gradient included) and ``step/apply`` (clip +
    optimizer).  Steps that loop over groups open a phase's span once per
    group, so a reader sums a step's spans by name."""
    opt = _make_optimizer(tc)
    sync = tc.sync
    mode = sync.mode
    if mode != "dense":
        compressor = dist.build_compressor(sync)
        lam, nu = dist.sync_params(sync, n_groups)

    def grad_fn(params, batch):
        """-> (loss, parts, grads): one backward, grads in the params' dtypes
        (an unused leaf gets zeros, as ``jax.grad`` gives)."""
        leaves, td = tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, parts = loss_fn(tree_unflatten(td, req), cfg, batch, remat=tc.remat)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                constrain_grads(tree_unflatten(td, grads)))

    def clip_and_step(grads, opt_state, params):
        norm = tree_norm(grads)
        return opt.step(grads, opt_state, params, scale=clip_scale(norm, tc.grad_clip)), norm

    # ------------------------------------------------------------------ dense
    def dense_step(state: TrainState, batch, survivors=None, noise=None):
        A = max(1, tc.grad_accum)
        with obs_trace.span("step/grad"):
            if A == 1:
                loss, parts, grads = grad_fn(state.params, batch)
                ce = parts["ce"]
            else:
                # microbatch accumulation in f32; the embedding gather is
                # hoisted out (constant inputs, as the reference's scan sees)
                batch = dict(batch)
                with torch.no_grad():
                    batch["inputs_embeds"] = embed(state.params["embed"], batch["tokens"])
                gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), state.params)
                lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                for a in range(A):
                    l, _, g = grad_fn(state.params, _split(batch, A, a))
                    for acc, gi in zip(tree_flatten(gsum)[0], tree_flatten(g)[0]):
                        acc.add_(gi.float())
                    del g
                    lsum = lsum + l
                grads = tree_map(lambda g: g.div_(A), gsum)
                loss = ce = lsum / A
        with obs_trace.span("step/apply"):
            opt_state, gnorm = clip_and_step(grads, state.opt_state, state.params)
        del grads
        metrics = {"loss": loss, "ce": ce, "grad_norm": gnorm}
        return TrainState(state.params, opt_state, None, state.generator), metrics

    # ------------------------------------------------------------- efbv-style
    fused = mode in ("efbv", "ef21", "diana") and dist.fused_path(compressor, sync.bucket_size)

    def efbv_step(state: TrainState, batch, survivors=None, noise=None):
        G = n_groups
        losses, ces = [], []
        if fused:
            layout = bk.bucket_layout(state.params, sync.bucket_size)
            g_b = torch.empty((G, layout.n_buckets, layout.bucket_size),
                              dtype=torch.float32,
                              device=tree_flatten(state.params)[0][0].device)
            for i in range(G):
                with obs_trace.span("step/grad"):
                    l, parts, grads = grad_fn(state.params, _split(batch, G, i))
                with obs_trace.span("step/sync"):
                    bk.bucketize_into(grads, g_b[i], layout)      # the sync's bucketize
                del grads
                losses.append(l)
                ces.append(parts["ce"])
        else:
            with obs_trace.span("step/grad"):
                per = []
                for i in range(G):
                    l, parts, grads = grad_fn(state.params, _split(batch, G, i))
                    per.append(tree_flatten(grads)[0])
                    losses.append(l)
                    ces.append(parts["ce"])
                td = tree_flatten(state.params)[1]
                grads_g = tree_unflatten(td, [torch.stack(ls) for ls in zip(*per)])
                del per
        with obs_trace.span("step/sync"):
            if fused:
                g_est, sync_state = dist.efbv_sync_buckets(
                    g_b, layout, state.sync_state, compressor, lam, nu,
                    noise=noise, generator=state.generator, like=state.params)
                del g_b
            else:
                g_est, sync_state = dist.efbv_sync(
                    grads_g, state.sync_state, compressor, lam, nu,
                    bucket_size=sync.bucket_size, noise=noise,
                    generator=state.generator, like=state.params)
                del grads_g
        with obs_trace.span("step/apply"):
            opt_state, gnorm = clip_and_step(g_est, state.opt_state, state.params)
        del g_est
        metrics = {"loss": torch.stack(losses).sum() / G,
                   "ce": torch.stack(ces).sum() / G, "grad_norm": gnorm}
        return TrainState(state.params, opt_state, sync_state, state.generator), metrics

    # ---------------------------------------------------- hier / local replicas
    cascade = (dist.build_cascade(sync) if mode == "hier" and sync.levels else None)
    G_rep = (_cascade_leaves(cascade) if cascade
             else (n_pods if mode == "hier" else n_groups))

    def local_step(state: TrainState, batch, survivors=None, noise=None):
        losses, gnorms = [], []
        opt_state = state.opt_state
        for i in range(G_rep):         # each replica's local update
            p_i = tree_map(lambda p: p[i], state.params)
            st_i = OptState(opt_state.step, tree_map(lambda m: m[i], opt_state.mu),
                            tree_map(lambda v: v[i], opt_state.nu))
            with obs_trace.span("step/grad"):
                l, _, grads = grad_fn(p_i, _split(batch, G_rep, i))
            with obs_trace.span("step/apply"):
                _, gnorm = clip_and_step(grads, st_i, p_i)
            del grads
            losses.append(l)
            gnorms.append(gnorm)
        opt_state = OptState(opt_state.step + 1, opt_state.mu, opt_state.nu)
        with obs_trace.span("step/sync"):
            if cascade:
                params_g, sync_state = dist.tree_param_sync(
                    state.params, state.sync_state, cascade,
                    bucket_size=sync.bucket_size, survivors=survivors,
                    noise=noise, generator=state.generator)
            else:
                params_g, sync_state = dist.hier_param_sync(
                    state.params, state.sync_state, compressor, lam,
                    sync.sync_period, bucket_size=sync.bucket_size,
                    survivors=survivors, noise=noise, generator=state.generator)
        loss = torch.stack(losses).sum() / G_rep
        metrics = {"loss": loss, "ce": loss, "grad_norm": torch.stack(gnorms).sum() / G_rep}
        return TrainState(params_g, opt_state, sync_state, state.generator), metrics

    if mode == "dense":
        return dense_step
    if mode in ("efbv", "ef21", "diana"):
        return efbv_step
    if mode in ("hier", "local"):
        return local_step
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (logits, cache)``: the model's prefill
    for ``cfg``.  The reference's factory also takes ``remat``, which only
    shapes what a backward pass recomputes; a prefill runs none."""
    def prefill_step(params, batch):
        return prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_one(params, token, cache) -> (logits, cache)``: one greedy
    decode step for ``cfg``; the cache is updated in place."""
    def decode_one(params, token, cache):
        return model_decode_step(params, cfg, token, cache)

    return decode_one
