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

Over a ``DeviceMesh`` (``make_train_step(..., mesh=)``, the dry-run's
production meshes) the state and batch are DTensors with
``sharding.rules``' placements.  The dense step runs as it is.  The
efbv / hier / local steps become per-rank steps: a rank computes only its
own group's (replica's) gradient on its own batch shard, on the sub-mesh
its group owns, and the groups meet in ``core.ef_bv``'s workers over the
process group of the group axes (``efbv_sync_worker``,
``param_sync_worker``), as the reference's partitioned program maps its
group axis onto the data axes.  The compressor sees each leaf whole, as
the reference's does: a rank gathers one leaf's f32 delta over its
group's sub-mesh, compresses it, keeps its own shard of the result and
sends only that shard to the other groups.  Every rank of a group draws
alike, from the group's generator (seeded from the state generator's
seed and the group's index on the first step); ``noise`` (nested as the
single-process per-leaf sync's, ``noise[li][i]`` for group i) replays the
single-process draws, so the step equals the single-process one for any
compressor.

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
from repro_torch.core.ef_bv import efbv_sync_worker, param_sync_worker
from repro_torch.sharding.layout import (AnyDTensor, group_axes, group_index, process_group,
                                        sub_mesh)
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
    """Group ``i`` of ``G`` equal slices of every batch array (of a DTensor:
    of each rank's local shard, so a microbatch stays on its ranks)."""
    def one(v):
        if isinstance(v, AnyDTensor):
            from torch.distributed.tensor import DTensor
            loc = one(v.to_local())
            shape = (v.shape[0] // G,) + tuple(v.shape[1:])
            return DTensor.from_local(loc, v.device_mesh, v.placements, run_check=False,
                                      shape=shape, stride=torch.empty(shape, device="meta").stride())
        return v.reshape((G, v.shape[0] // G) + tuple(v.shape[1:]))[i]

    return {k: one(v) for k, v in batch.items()}


def _localize(x, mesh, axes, sub, drop_lead: bool = False):
    """DTensor ``x`` on ``mesh`` -> the part this rank's coordinate on the
    mesh axes ``axes`` selects, as a DTensor on ``sub``, the sub-mesh of the
    other axes, sharing ``x``'s local storage.  With ``drop_lead`` the leading
    dim (sharded over exactly ``axes``, one index per rank: a group or
    replica axis) is removed."""
    from torch.distributed.tensor import DTensor, Shard

    names = mesh.mesh_dim_names
    keep = tuple(a for a in names if a not in axes)
    loc = x.to_local()
    pl = [p for a, p in zip(names, x.placements) if a in keep]
    if drop_lead:
        loc = loc[0]
        pl = [Shard(p.dim - 1) if p.is_shard() else p for p in pl]
    shape = list(loc.shape)
    for a, p in zip(keep, pl):
        if p.is_shard():
            shape[p.dim] *= mesh.size(names.index(a))
    return DTensor.from_local(loc, sub, pl, run_check=False, shape=tuple(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _gathered_over(x, mesh, axes):
    """DTensor ``x`` with its shards over the mesh axes ``axes`` gathered."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(mesh, [Replicate() if a in axes else p
                                 for a, p in zip(mesh.mesh_dim_names, x.placements)])


def _whole_leaf_compress(c, likes):
    """The ``compress`` hook of ``core.ef_bv``'s workers for a rank that
    holds shards: leaf li's local delta, laid out as the DTensor
    ``likes[li]`` on its sub-mesh, is gathered whole there, compressed, and
    this rank's shard of the result returned (a slice: no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    def compress(li, x, noise, generator):
        like = likes[li]
        mesh = like.device_mesh
        whole = DTensor.from_local(x, mesh, like.placements, run_check=False,
                                   shape=like.shape, stride=like.stride()).full_tensor()
        d = c(whole, noise=noise, generator=generator)
        del whole
        return DTensor.from_local(d, mesh, [Replicate()] * mesh.ndim, run_check=False
                                  ).redistribute(mesh, like.placements).to_local()

    return compress


def _group_mean(x, group):
    """A 0-d metric (a DTensor on a sub-mesh, or a tensor) averaged over the
    ranks of the process group ``group``."""
    import torch.distributed as tdist
    x = (x.full_tensor() if isinstance(x, AnyDTensor) else x).clone()
    tdist.all_reduce(x, group=group)
    return x / tdist.get_world_size(group)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_groups: int, n_pods: int,
                    mesh=None):
    """The step for ``tc.sync.mode``.  Its phases are ``obs.trace`` spans:
    ``step/grad`` (forward + backward), ``step/sync`` (the fused efbv step's
    bucketize of each group's gradient included) and ``step/apply`` (clip +
    optimizer).  Steps that loop over groups open a phase's span once per
    group, so a reader sums a step's spans by name.  Each backward pass
    holds a ``step/grad/forward`` (the loss) and a ``step/grad/backward``
    (``autograd.grad``, the remat recompute included) span.

    ``mesh``: the ``DeviceMesh`` the state's DTensors live on; the efbv
    family and hier / local then take their per-rank forms (the module
    docstring).  The efbv state is per leaf there (``h`` (G, ...) over the
    data axes, ``h_bar`` as the params), as the reference's dry-run lays it
    out."""
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
            with obs_trace.span("step/grad/forward"):
                loss, parts = loss_fn(tree_unflatten(td, req), cfg, batch, remat=tc.remat)
            with obs_trace.span("step/grad/backward"):      # the remat recompute included
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
                gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                state.params)
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

    # ----------------------------------------------- per-rank forms on a mesh
    if mesh is not None and mode != "dense":
        # this rank's group (replica): the mesh axes the groups lie on, the
        # sub-mesh of the other axes it computes on, its process group and
        # its index, made once (the mesh's bookkeeping runs host tensor ops)
        g_axes = group_axes(mesh, mode)
        g_sub, group = sub_mesh(mesh, g_axes), process_group(mesh, g_axes)
        gi = group_index(mesh, g_axes)

        def lz(x, drop_lead=False):
            return _localize(x, mesh, g_axes, g_sub, drop_lead)

        group_gen = []

        def group_generator(state):
            """This group's generator, made on the first step from the state
            generator's seed and the group index: every rank of the group
            draws the same uniforms for a leaf, each group its own."""
            if not group_gen:
                seed = (state.generator.initial_seed() * 1_000_003 + gi) % (1 << 63)
                group_gen.append(torch.Generator(device=state.generator.device)
                                 .manual_seed(seed))
            return group_gen[0]

    def efbv_rank_step(state: TrainState, batch, survivors=None, noise=None):
        """This rank's group: its batch shard, the params gathered over the
        data axes (tensor-parallel over ``"model"`` only), one backward,
        then ``efbv_sync_worker`` leaf by leaf over the data axes' group,
        each leaf's delta compressed whole."""
        from torch.distributed.tensor import DTensor
        gen = group_generator(state)
        params = tree_map(lambda p: lz(_gathered_over(p, mesh, g_axes)), state.params)
        with obs_trace.span("step/grad"):
            loss, parts, grads = grad_fn(params, {k: lz(v) for k, v in batch.items()})
        del params
        st = state.sync_state
        g_est = []
        with obs_trace.span("step/sync"):
            for li, (g, p, h, hb) in enumerate(zip(*(tree_flatten(t)[0] for t in (
                    grads, state.params, st.h, st.h_bar)))):
                like = g.redistribute(g.device_mesh, lz(p).placements)
                g = like.to_local()
                h_i = lz(h, drop_lead=True).to_local()
                hb_full = _gathered_over(hb, mesh, g_axes)
                ge, nh, nhb = efbv_sync_worker(
                    [g], [h_i], [lz(hb_full).to_local()], compressor,
                    lam, nu, group=group, generator=gen,
                    noise=None if noise is None else [noise[li][gi]],
                    compress=_whole_leaf_compress(compressor, [like]))
                h_i.copy_(nh[0])
                back = [DTensor.from_local(t[0], mesh, hb_full.placements, run_check=False,
                                           shape=hb.shape, stride=hb.stride())
                        .redistribute(mesh, p.placements) for t in (ge, nhb)]
                hb.to_local().copy_(back[1].to_local())
                g_est.append(back[0])
                del g, ge, nh, nhb, hb_full, back, like
        grads = tree_unflatten(tree_flatten(state.params)[1], g_est)
        with obs_trace.span("step/apply"):
            opt_state, gnorm = clip_and_step(grads, state.opt_state, state.params)
        del grads, g_est
        sync_state = dist.SyncState(h=st.h, h_bar=st.h_bar, step=st.step + 1)
        metrics = {"loss": _group_mean(loss, group), "ce": _group_mean(parts["ce"], group),
                   "grad_norm": gnorm}
        return TrainState(state.params, opt_state, sync_state, state.generator), metrics

    def local_rank_step(state: TrainState, batch, survivors=None, noise=None):
        """This rank's replica (its index on the replica axes: "pod" for
        hier, the data axes for local): a local step on the sub-mesh the
        replica owns, in place, then, in a round where the sync fires,
        ``param_sync_worker`` over the replica axes' group, each leaf
        compressed whole over the replica's sub-mesh."""
        rep = lambda t: lz(t, drop_lead=True)                          # noqa: E731
        params = tree_map(rep, state.params)
        st_r = OptState(state.opt_state.step, tree_map(rep, state.opt_state.mu),
                        tree_map(rep, state.opt_state.nu))
        with obs_trace.span("step/grad"):
            loss, _, grads = grad_fn(params, {k: lz(v) for k, v in batch.items()})
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                         grads, params)
        with obs_trace.span("step/apply"):
            _, gnorm = clip_and_step(grads, st_r, params)
        del grads
        st = state.sync_state
        h_bar = st.h_bar
        with obs_trace.span("step/sync"):
            if st.step % sync.sync_period == sync.sync_period - 1:
                local = lambda t: t.to_local()                          # noqa: E731
                new_hb = param_sync_worker(
                    tree_map(local, params), tree_map(local, h_bar), compressor, lam,
                    group=group, generator=group_generator(state),
                    noise=None if noise is None else [n[gi] for n in noise],
                    compress=_whole_leaf_compress(compressor, tree_flatten(params)[0]))
                for hb, n in zip(tree_flatten(h_bar)[0], tree_flatten(new_hb)[0]):
                    hb.to_local().copy_(n)
                del new_hb
        opt_state = OptState(state.opt_state.step + 1, state.opt_state.mu,
                             state.opt_state.nu)
        sync_state = dist.SyncState(h=st.h, h_bar=h_bar, step=st.step + 1)
        loss = _group_mean(loss, group)
        metrics = {"loss": loss, "ce": loss,
                   "grad_norm": _group_mean(gnorm, group)}
        return TrainState(state.params, opt_state, sync_state, state.generator), metrics

    if mode == "dense":
        return dense_step
    if mode in ("efbv", "ef21", "diana"):
        return efbv_step if mesh is None else efbv_rank_step
    if mode in ("hier", "local"):
        if mesh is not None and cascade:
            raise NotImplementedError("an aggregation-tree cascade over a mesh")
        return local_step if mesh is None else local_rank_step
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
